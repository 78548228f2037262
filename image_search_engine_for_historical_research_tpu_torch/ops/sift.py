"""SIFT on the device: batched DoG keypoints and descriptors in torch ops.

Port of ``image_search_engine_for_historical_research_tpu/ops/sift.py``
(:39-480): Lowe's constants, ``_gauss_kernel1d``, ``_blur``,
``gaussian_octave``, ``_shift2d``, ``dog_keypoint_scores``,
``_extract_patches``, ``_orientation``, ``_descriptor``,
``_octave_keypoints``, ``default_budgets``, ``sift_program``,
``make_sharded_sift_fn`` (the batch split over a ``parallel.data_mesh``)
and ``sift_extract_batch``.

A batch of images runs the Gaussian / DoG pyramid, extrema detection,
orientation assignment and descriptor pooling as one sequence of tensor ops
with static shapes: a fixed keypoint budget per octave, invalid slots
carrying score ``-inf``. JAX's ``vmap`` over images is a batch dimension
here.

The four departures from OpenCV are the JAX package's, kept as they are:
no initial 2x upsampled octave; one clamped Newton step of subpixel
refinement instead of OpenCV's up-to-5-step loop; secondary orientations
(histogram peaks >= 0.8 x max) compete with weaker detections for the same
fixed budget, demoted by an epsilon so that primaries win ties; Gaussian
blurs pad by replicating the edge (OpenCV reflects).

What the translation keeps from JAX:

- ``_shift2d`` is ``jnp.roll``: it wraps around (the border mask drops what
  the wrap touches), and so does ``torch.roll`` here.
- Both keypoint selections are ``lax.top_k``: the lower index first among
  equal scores, and many slots are ``-inf``. They go through
  ``ops.topk._top_exact`` (a stable descending sort), never a bare
  ``torch.topk``.
- ``lax.dynamic_slice`` counts a negative start index from the end and
  clamps every start so the window fits; the patch gather takes its starts
  the same way.
- Every f32 product stays f32 on the card: the blurs and the descriptor's
  einsum run with TF32 off (``_full_f32``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .topk import _full_f32, _top_exact

# --- Lowe's constants (values as in the paper / OpenCV defaults) ------------
SIGMA0 = 1.6          # base scale of each octave
S = 3                 # intervals per octave (=> 6 gaussian / 5 DoG levels)
CONTRAST_THR = 0.04   # refined-contrast threshold (image range [0, 1])
EDGE_R = 10.0         # edge-response (Hessian ratio) threshold
N_ORI_BINS = 36
ORI_SIGMA_FACTOR = 1.5        # orientation window sigma = 1.5 * sigma_oct
ORI_RADIUS_FACTOR = 4.5       # orientation window radius = 3 * 1.5 * sigma
DESC_D = 4                    # descriptor spatial bins per side
DESC_B = 8                    # orientation bins
DESC_HIST_WIDTH = 3.0         # cell width = 3 * sigma_oct
DESC_SAMPLES = 16             # sample lattice per side (4 per cell)
PATCH = 72                    # per-keypoint window (covers max descriptor radius)
HALF = PATCH // 2

TWO_PI = 2 * math.pi


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur, edge-replicate padding. img: (B, H, W)."""
    k = torch.as_tensor(kernel, device=img.device)
    r = (k.shape[0] - 1) // 2
    x = F.pad(img[:, None], (0, 0, r, r), mode="replicate")      # (B, 1, H + 2r, W)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.pad(x, (r, r, 0, 0), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x[:, 0]


def gaussian_octave(base: torch.Tensor) -> torch.Tensor:
    """(B, H, W) at sigma = SIGMA0 -> (B, L=S+3, H, W) gaussian levels."""
    levels = [base]
    for lv in range(1, S + 3):
        s_prev = SIGMA0 * (2.0 ** ((lv - 1) / S))
        s_cur = SIGMA0 * (2.0 ** (lv / S))
        levels.append(_blur(levels[-1], _gauss_kernel1d(
            math.sqrt(s_cur * s_cur - s_prev * s_prev))))
    return torch.stack(levels, dim=1)


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift (..., H, W) by (dy, dx), wrapping around as ``jnp.roll`` does."""
    return torch.roll(torch.roll(x, dy, dims=-2), dx, dims=-1)


def dog_keypoint_scores(gauss: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked refined-contrast scores for one octave.

    gauss: (B, L, H, W). Returns (score (B, 3, H, W) with -inf at rejected
    positions, offsets (B, 3, H, W, 3) the clamped subpixel offset
    (dl, dy, dx)).
    """
    dog = gauss[:, 1:] - gauss[:, :-1]                     # (B, 5, H, W)
    c = dog[:, 1:4]                                        # centers (B, 3, H, W)

    # 26-neighbourhood max / min over the 3 adjacent levels, as running
    # maxima (exact, like JAX's max over the stacked shifts)
    nmax = nmin = None
    for dl in (-1, 0, 1):
        lvl = dog[:, 1 + dl:4 + dl]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dl == 0 and dy == 0 and dx == 0:
                    continue
                sh = _shift2d(lvl, dy, dx)
                nmax = sh if nmax is None else torch.maximum(nmax, sh)
                nmin = sh if nmin is None else torch.minimum(nmin, sh)
    is_ext = ((c > nmax) | (c < nmin)) & (torch.abs(c) > 0.5 * CONTRAST_THR / S)

    # finite-difference 3D gradient / Hessian at every position
    up, lo = dog[:, 2:5], dog[:, 0:3]
    d_dx = (_shift2d(c, 0, -1) - _shift2d(c, 0, 1)) * 0.5
    d_dy = (_shift2d(c, -1, 0) - _shift2d(c, 1, 0)) * 0.5
    d_dl = (up - lo) * 0.5
    dxx = _shift2d(c, 0, -1) + _shift2d(c, 0, 1) - 2 * c
    dyy = _shift2d(c, -1, 0) + _shift2d(c, 1, 0) - 2 * c
    dll = up + lo - 2 * c
    dxy = (_shift2d(c, -1, -1) + _shift2d(c, 1, 1)
           - _shift2d(c, -1, 1) - _shift2d(c, 1, -1)) * 0.25
    dxl = ((_shift2d(up, 0, -1) - _shift2d(up, 0, 1))
           - (_shift2d(lo, 0, -1) - _shift2d(lo, 0, 1))) * 0.25
    dyl = ((_shift2d(up, -1, 0) - _shift2d(up, 1, 0))
           - (_shift2d(lo, -1, 0) - _shift2d(lo, 1, 0))) * 0.25

    # edge rejection: 2D spatial Hessian ratio (Lowe sec. 4.1)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr * EDGE_R < (EDGE_R + 1) ** 2 * det)

    # one Newton step: offset = -H^-1 g (3x3 solve via adjugate), clamped
    a, b_, cc = dxx, dxy, dxl
    d, e = dyy, dyl
    f = dll
    A11 = d * f - e * e
    A12 = cc * e - b_ * f
    A13 = b_ * e - cc * d
    A22 = a * f - cc * cc
    A23 = b_ * cc - a * e
    A33 = a * d - b_ * b_
    detH = a * A11 + b_ * A12 + cc * A13
    safe = torch.where(torch.abs(detH) > 1e-12, detH, torch.ones_like(detH))
    gx, gy, gl = d_dx, d_dy, d_dl
    ox = torch.clamp(-(A11 * gx + A12 * gy + A13 * gl) / safe, -0.5, 0.5)
    oy = torch.clamp(-(A12 * gx + A22 * gy + A23 * gl) / safe, -0.5, 0.5)
    ol = torch.clamp(-(A13 * gx + A23 * gy + A33 * gl) / safe, -0.5, 0.5)
    d_hat = c + 0.5 * (gx * ox + gy * oy + gl * ol)

    ok = is_ext & edge_ok & (torch.abs(d_hat) * S >= CONTRAST_THR)
    # keep a margin so orientation / descriptor windows stay informative
    H, W = c.shape[-2:]
    border = 5
    yy = torch.arange(H, device=c.device)
    xx = torch.arange(W, device=c.device)
    inb = ((yy >= border) & (yy < H - border))[:, None] & (
        (xx >= border) & (xx < W - border))[None, :]
    ok = ok & inb
    score = torch.where(ok, torch.abs(d_hat), torch.full_like(d_hat, -math.inf))
    return score, torch.stack([ol, oy, ox], dim=-1)


def _extract_patches(gauss_pad: torch.Tensor, lvl: torch.Tensor,
                     yc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Per-keypoint (PATCH, PATCH) windows. gauss_pad: (B, L, H+2*HALF,
    W+2*HALF); lvl / yc / xc: (B, K) integer level / window start (the
    keypoint's position in the unpadded frame). Starts are taken as
    ``lax.dynamic_slice`` takes them: a negative one counts from the end,
    then each is clamped so the window fits. Returns (B, K, PATCH, PATCH)."""
    B, L, Hp, Wp = gauss_pad.shape

    def start(i, dim, size):
        return torch.where(i < 0, i + dim, i).clamp(0, dim - size)

    lvl, y0, x0 = start(lvl, L, 1), start(yc, Hp, PATCH), start(xc, Wp, PATCH)
    r = torch.arange(PATCH, device=gauss_pad.device)
    rows = (y0[..., None] + r)[..., :, None]                   # (B, K, P, 1)
    cols = (x0[..., None] + r)[..., None, :]                   # (B, K, 1, P)
    b = torch.arange(B, device=gauss_pad.device)[:, None, None, None]
    return gauss_pad[b, lvl[..., None, None], rows, cols]


def _orientation(patches: torch.Tensor, sigma_oct: torch.Tensor):
    """Dominant gradient orientation per patch (K, PATCH, PATCH) -> (K,)
    primary angle, secondary angle and whether the secondary counts."""
    K = patches.shape[0]
    dx = (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]) * 0.5
    dy = (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1]) * 0.5
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.remainder(torch.atan2(dy, dx), TWO_PI)

    n = PATCH - 2
    rr = torch.arange(n, dtype=torch.float32, device=patches.device) - (HALF - 1)
    r2 = rr[:, None] ** 2 + rr[None, :] ** 2
    sig = (ORI_SIGMA_FACTOR * sigma_oct)[:, None, None]
    w = torch.exp(-r2[None] / (2 * sig * sig))
    w = torch.where(r2[None] <= (ORI_RADIUS_FACTOR * sigma_oct[:, None, None]) ** 2,
                    w, torch.zeros_like(w))
    wm = (w * mag).reshape(K, -1)

    # 36-bin histogram, one hat-weighted reduction a bin (each pixel votes
    # for its two adjacent bins with linear interpolation weights)
    binf = ang.reshape(K, -1) * (N_ORI_BINS / TWO_PI)
    cols = []
    for b in range(N_ORI_BINS):
        dist = torch.abs(binf - b)
        dist = torch.minimum(dist, N_ORI_BINS - dist)        # circular
        cols.append(torch.sum(wm * torch.clamp(1.0 - dist, min=0.0), dim=1))
    hist = torch.stack(cols, dim=1)                          # (K, 36)

    # 5-tap circular smoothing [1,4,6,4,1]/16
    sm = (torch.roll(hist, 2, -1) + 4 * torch.roll(hist, 1, -1) + 6 * hist
          + 4 * torch.roll(hist, -1, -1) + torch.roll(hist, -2, -1)) / 16.0

    def refine(peak):
        hl = torch.gather(sm, 1, ((peak - 1) % N_ORI_BINS)[:, None])[:, 0]
        hc = torch.gather(sm, 1, peak[:, None])[:, 0]
        hr = torch.gather(sm, 1, ((peak + 1) % N_ORI_BINS)[:, None])[:, 0]
        denom = hl - 2 * hc + hr
        interp = torch.where(
            torch.abs(denom) > 1e-12,
            0.5 * (hl - hr) / torch.where(denom == 0, torch.ones_like(denom), denom),
            torch.zeros_like(denom))
        return torch.remainder((peak + interp) * (TWO_PI / N_ORI_BINS), TWO_PI), hc

    peak = torch.argmax(sm, dim=-1)
    theta1, v1 = refine(peak)

    # secondary orientation: best LOCAL maximum away from the main peak;
    # OpenCV duplicates the keypoint when it reaches >= 0.8 * max
    is_local = (sm > torch.roll(sm, 1, -1)) & (sm >= torch.roll(sm, -1, -1))
    bins = torch.arange(N_ORI_BINS, device=sm.device)
    d_to_peak = torch.abs(bins[None, :] - peak[:, None])
    d_to_peak = torch.minimum(d_to_peak, N_ORI_BINS - d_to_peak)
    cand = torch.where(is_local & (d_to_peak > 1), sm, torch.full_like(sm, -math.inf))
    peak2 = torch.argmax(cand, dim=-1)
    v2 = torch.gather(cand, 1, peak2[:, None])[:, 0]
    theta2, _ = refine(peak2)
    ok2 = torch.isfinite(v2) & (v2 >= 0.8 * v1)
    return theta1, theta2, ok2


def _descriptor(patches: torch.Tensor, theta: torch.Tensor,
                sigma_oct: torch.Tensor) -> torch.Tensor:
    """(K, PATCH, PATCH) patches + orientations -> (K, 128) descriptors.

    16x16 sample lattice in the rotated keypoint frame; gradients are
    bilinearly sampled from the patch; trilinear (row, col, orientation)
    soft-assignment is an einsum of hat weights."""
    K = patches.shape[0]
    dev = patches.device
    dxp = (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]) * 0.5
    dyp = (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1]) * 0.5
    n = PATCH - 2
    ctr = HALF - 1.0

    # rotated sample lattice: 16x16, spacing = hist_width/4 (window 12 sigma)
    u = torch.arange(DESC_SAMPLES, dtype=torch.float32, device=dev) - (DESC_SAMPLES - 1) / 2
    uu, vv = torch.meshgrid(u, u, indexing="ij")           # rows, cols
    uu = uu.reshape(-1)
    vv = vv.reshape(-1)                                    # (P=256,)
    spacing = (DESC_HIST_WIDTH * sigma_oct / 4.0)[:, None]    # (K, 1)
    cos_t = torch.cos(theta)[:, None]
    sin_t = torch.sin(theta)[:, None]
    dx_s = spacing * (vv[None] * cos_t - uu[None] * sin_t)
    dy_s = spacing * (vv[None] * sin_t + uu[None] * cos_t)
    ys = ctr + dy_s                                        # (K, P)
    xs = ctr + dx_s

    # bilinear gradient sampling from the (n, n) interior grids
    y0 = torch.clamp(torch.floor(ys), 0, n - 2).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, n - 2).to(torch.int64)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    flat_dx = dxp.reshape(K, -1)
    flat_dy = dyp.reshape(K, -1)

    def bsample(flat):
        v00 = torch.gather(flat, 1, y0 * n + x0)
        v01 = torch.gather(flat, 1, y0 * n + x0 + 1)
        v10 = torch.gather(flat, 1, (y0 + 1) * n + x0)
        v11 = torch.gather(flat, 1, (y0 + 1) * n + x0 + 1)
        return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
                + v10 * fy * (1 - fx) + v11 * fy * fx)

    gx = bsample(flat_dx)
    gy = bsample(flat_dy)                                  # (K, P)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.atan2(gy, gx) - theta[:, None], TWO_PI)

    # Gaussian spatial weight over normalized bin coords (Lowe: sigma = d/2)
    rbin = uu[None] / 4.0 + (DESC_D - 1) / 2.0             # (1, P) in [0, 3]
    cbin = vv[None] / 4.0 + (DESC_D - 1) / 2.0
    wspat = torch.exp(-((rbin - 1.5) ** 2 + (cbin - 1.5) ** 2) / (0.5 * DESC_D * DESC_D))
    m = mag * wspat                                        # (K, P)

    bins = torch.arange(DESC_D, dtype=torch.float32, device=dev)
    wr = torch.clamp(1.0 - torch.abs(rbin[..., None] - bins), min=0.0)   # (1, P, 4)
    wc = torch.clamp(1.0 - torch.abs(cbin[..., None] - bins), min=0.0)
    obinf = ang * (DESC_B / TWO_PI)
    ob = torch.arange(DESC_B, dtype=torch.float32, device=dev)
    od = torch.abs(obinf[..., None] - ob)
    od = torch.minimum(od, DESC_B - od)
    wo = torch.clamp(1.0 - od, min=0.0)                    # (K, P, 8)

    mw = m[..., None] * wo                                 # (K, P, 8)
    desc = torch.einsum("kpo,pr,pc->krco", mw, wr[0], wc[0]).reshape(
        K, DESC_D * DESC_D * DESC_B)
    # normalize -> clip 0.2 -> renormalize (illumination robustness)
    desc = desc / (torch.linalg.norm(desc, dim=1, keepdim=True) + 1e-12)
    desc = torch.clamp(desc, max=0.2)
    return desc / (torch.linalg.norm(desc, dim=1, keepdim=True) + 1e-12)


def _octave_keypoints(gauss: torch.Tensor, budget: int):
    """One octave of a batch: gauss (B, L, H, W) -> padded keypoint fields
    (B, budget, ...)."""
    score, offsets = dog_keypoint_scores(gauss)            # (B, 3, H, W)
    B, _, H, W = score.shape
    dev = score.device
    # deep octaves of small images can have fewer grid cells than the
    # budget: clamp the top-k and pad the outputs back to `budget` below
    kb = min(budget, 3 * H * W)
    vals, flat = _top_exact(score.reshape(B, -1), kb)
    valid = torch.isfinite(vals)
    lvl = flat // (H * W)
    rem = flat % (H * W)
    yi = rem // W
    xi = rem % W
    bi = torch.arange(B, device=dev)[:, None]
    off = offsets[bi, lvl, yi, xi]                         # (B, kb, 3)

    sigma_oct = SIGMA0 * torch.exp2((lvl.float() + 1 + off[..., 0]) / S)
    y = yi.float() + off[..., 1]
    x = xi.float() + off[..., 2]

    gauss_pad = F.pad(gauss, (HALF, HALF, HALF, HALF), mode="replicate")
    # window centre in the padded frame: the integer keypoint position
    patches = _extract_patches(gauss_pad, lvl + 1, yi, xi).reshape(B * kb, PATCH, PATCH)
    sig = sigma_oct.reshape(-1)
    theta1, theta2, ok2 = _orientation(patches, sig)

    # secondary-orientation duplicates compete with weaker detections for
    # the SAME fixed budget, ranked by DoG score with the duplicate
    # epsilon-demoted so primaries win ties
    desc1 = _descriptor(patches, theta1, sig).reshape(B, kb, -1)
    desc2 = _descriptor(patches, theta2, sig).reshape(B, kb, -1)
    ninf = torch.full_like(vals, -math.inf)
    score1 = torch.where(valid, vals, ninf)
    score2 = torch.where(valid & ok2.reshape(B, kb), vals * (1.0 - 1e-6) - 1e-12, ninf)

    xy = torch.stack([x, y], dim=-1)
    kf = min(budget, 2 * kb)
    sel_vals, sel = _top_exact(torch.cat([score1, score2], 1), kf)

    def pick(a, b_):
        both = torch.cat([a, b_], 1)
        idx = sel.reshape(B, kf, *([1] * (both.dim() - 2))).expand(B, kf, *both.shape[2:])
        return torch.gather(both, 1, idx)

    out = {
        "xy": pick(xy, xy),
        "sigma": pick(sigma_oct, sigma_oct),
        "theta": pick(theta1.reshape(B, kb), theta2.reshape(B, kb)),
        "desc": pick(desc1, desc2),
        "score": sel_vals,
        "valid": torch.isfinite(sel_vals),
    }
    if kf < budget:  # pad invalid slots to the static per-octave budget
        pad = budget - kf
        out = {k: torch.cat([v, torch.zeros((B, pad) + v.shape[2:], dtype=v.dtype, device=dev)],
                            1) for k, v in out.items()}
        out["score"][:, kf:] = -math.inf
    return out


def default_budgets(max_kpts: int, n_octaves: int) -> Tuple[int, ...]:
    """Geometric split of the keypoint budget across octaves (finest gets
    half — matching the typical DoG keypoint distribution)."""
    budgets = []
    rem = max_kpts
    for o in range(n_octaves):
        b = max(16, rem // 2) if o < n_octaves - 1 else rem
        b = min(b, rem)
        budgets.append(b)
        rem -= b
        if rem <= 0:
            budgets += [0] * (n_octaves - len(budgets))
            break
    return tuple(budgets)


def sift_program(images: torch.Tensor, n_octaves: int, budgets: Tuple[int, ...]):
    """(B, H, W) float32 grayscale in [0, 1] -> dict of padded SIFT fields,
    on the images' device.

    Output coordinates / scales are in INPUT-image pixels. Fields: xy
    (B, K, 2), scale (B, K) (= OpenCV's ``kp.size`` / 2, i.e. sigma), angle
    (B, K) radians, desc (B, K, 128), valid (B, K), score (B, K); K = sum of
    per-octave budgets, invalid slots zeroed.
    """
    with _full_f32():
        base = _blur(images.float(), _gauss_kernel1d(math.sqrt(max(SIGMA0 ** 2 - 0.25, 0.01))))
        outs = []
        for o in range(n_octaves):
            gauss = gaussian_octave(base)                  # (B, L, Ho, Wo)
            if budgets[o] > 0:
                per = _octave_keypoints(gauss, budgets[o])
                scale_fac = float(2 ** o)
                outs.append({
                    "xy": per["xy"] * scale_fac,
                    "scale": per["sigma"] * scale_fac,
                    "angle": per["theta"],
                    "desc": per["desc"],
                    "score": per["score"],
                    "valid": per["valid"],
                })
            if o < n_octaves - 1:
                base = gauss[:, S, ::2, ::2]               # sigma doubles, res halves

    cat = {k: torch.cat([u[k] for u in outs], dim=1) for k in outs[0]}
    v = cat["valid"]
    cat["xy"] = torch.where(v[..., None], cat["xy"], torch.zeros_like(cat["xy"]))
    cat["scale"] = torch.where(v, cat["scale"], torch.zeros_like(cat["scale"]))
    cat["angle"] = torch.where(v, cat["angle"], torch.zeros_like(cat["angle"]))
    cat["desc"] = torch.where(v[..., None], cat["desc"], torch.zeros_like(cat["desc"]))
    return cat


def make_sharded_sift_fn(mesh, hw: Optional[Tuple[int, int]] = None, max_kpts: int = 1024,
                         n_octaves: int = 4, axis: str = "data"):
    """``sift_program`` with the image batch split over ``mesh``'s ``axis``:
    every rank calls ``fn(images (B, H, W))`` on the same whole batch (a
    tensor or a ``parallel.shard_batch`` result), runs the pyramid and the
    keypoints of its own block of images and gets back every field of the
    whole batch (one all-gather a field; the images need nothing from each
    other). The batch must divide the mesh; ``hw``, when given, must be the
    images' ``(H, W)`` (``ValueError`` otherwise)."""
    from ..parallel.mesh import gather_rows, local_rows, mesh_size

    mesh_size(mesh, axis)
    budgets = default_budgets(max_kpts, n_octaves)

    def fn(images):
        if hw is not None and tuple(images.shape[1:3]) != tuple(hw):
            raise ValueError(f"sharded SIFT fn built for hw={tuple(hw)}, got batch "
                             f"{tuple(images.shape)}")
        local, _ = local_rows(images, mesh, axis)
        out = sift_program(local, n_octaves, budgets)
        return {k: gather_rows(v, mesh, axis) for k, v in out.items()}

    return fn


def sift_extract_batch(images, max_kpts: int = 1024, n_octaves: int = 4, device="cuda"):
    """Host entry: (B, H, W) [0, 1] grayscale -> list of per-image dicts
    (numpy) compatible with ``rerank.geometric.LocalFeatures`` fields, valid
    slots first. Runs on ``device``."""
    from ..device import resolve_device

    dev = resolve_device(device)
    images = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    out = sift_program(images, n_octaves, default_budgets(max_kpts, n_octaves))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    feats = []
    for b in range(images.shape[0]):
        valid = out["valid"][b]
        order = np.argsort(~valid, kind="stable")         # valid slots first
        feats.append({
            "xy": out["xy"][b][order],
            "scale": out["scale"][b][order],
            "angle": out["angle"][b][order],
            "desc": out["desc"][b][order],
            "count": int(valid.sum()),
        })
    return feats
