"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

# one bottleneck per stage at full width: the stem, SOA4/SOA5 and the 2048-d
# head are the real ResNet101-SOLAR widths, at a fraction of the CPU time
ONE_BLOCK = "resnet_1111"


@contextlib.contextmanager
def one_block_arch():
    """Register ``ONE_BLOCK`` in both packages' architecture tables."""
    from image_search_engine_for_historical_research_tpu.models import resnet as jresnet
    from image_search_engine_for_historical_research_tpu.models import retrieval as jretrieval
    from image_search_engine_for_historical_research_tpu_torch.models import resnet as tresnet
    from image_search_engine_for_historical_research_tpu_torch.models import (
        retrieval as tretrieval,
    )

    with pytest.MonkeyPatch.context() as mp:
        for table in (jresnet.STAGE_BLOCKS, tresnet.STAGE_BLOCKS):
            mp.setitem(table, ONE_BLOCK, (1, 1, 1, 1))
        for table in (jretrieval.OUTPUT_DIM, tretrieval.OUTPUT_DIM):
            mp.setitem(table, ONE_BLOCK, 2048)
        yield


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch intra-op thread while a module runs. Its tests run many small
    ops, and a test run with several workers on few cores would otherwise
    oversubscribe the CPU with each worker's own thread pool."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_bf16_dots():
    """Let the JAX package's bf16 paths run on the CPU: their einsums take
    bf16 operands with ``preferred_element_type=float32``, which XLA's CPU
    runtime refuses ("BF16 x BF16 = F32"). Inside the context such an
    einsum casts its bf16 operands to f32 first; a product of two bf16
    values is exact in f32, so it is the same sum, accumulated in f32, that
    an accelerator computes. Trace the JAX functions inside the context."""
    import jax.numpy as jnp

    einsum = jnp.einsum

    def f32_einsum(subscripts, *operands, preferred_element_type=None, **kw):
        if preferred_element_type is not None:
            operands = [jnp.asarray(o).astype(preferred_element_type)
                        if jnp.asarray(o).dtype == jnp.bfloat16 else o for o in operands]
        return einsum(subscripts, *operands, preferred_element_type=preferred_element_type, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "einsum", f32_einsum)
        yield


def perturbed_variables(variables, seed: int = 0):
    """Numpy copy of a Flax variable tree with every parameter and BN
    statistic moved by seeded noise: without it the SOA ``v`` conv is zero,
    SOA is the identity and attention is never tested."""
    rng = np.random.default_rng(seed)

    def perturb(a, leaf):
        noise = rng.standard_normal(a.shape)
        if leaf == "kernel":
            return a + 0.5 * noise / np.sqrt(np.prod(a.shape[:-1]))
        if leaf == "var":
            return a * np.exp(0.2 * noise)
        if leaf == "gem_p":
            return a + 0.25 * np.abs(noise)
        return a + 0.1 * noise                 # scale, bias, mean

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        return np.asarray(perturb(a, path[-1]), np.float32)

    return walk(variables, ())


def write_images(directory, n: int, seed: int, n_classes: int = 3):
    """``n`` JPEGs of two aspect ratios: a per-class smooth pattern plus a
    strong per-image pattern, so descriptors are distinct and scores do not
    nearly tie."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    bases = rng.uniform(0, 255, (n_classes, 6, 8, 3))
    paths = []
    for i in range(n):
        h, w = (72, 96) if i % 2 == 0 else (96, 72)
        base = np.asarray(
            Image.fromarray(bases[i % n_classes].astype(np.uint8)).resize((w, h), Image.BILINEAR),
            np.float32,
        )
        own = np.asarray(
            Image.fromarray(rng.uniform(0, 255, (4, 4, 3)).astype(np.uint8)).resize(
                (w, h), Image.BILINEAR
            ),
            np.float32,
        )
        arr = 0.6 * base + 0.4 * own + rng.normal(0, 8, (h, w, 3))
        p = os.path.join(directory, f"im{i:02d}.jpg")
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(p, quality=92)
        paths.append(p)
    return paths


def assert_same_beams(s_ref, i_ref, s_got, i_got, atol=1e-4, tie=1e-5):
    """Each row holds the same ids with the same scores (``atol``); where the
    order differs, the scores at those ranks are within ``tie``."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    assert i_ref.shape == i_got.shape
    for r in range(i_ref.shape[0]):
        assert sorted(i_ref[r].tolist()) == sorted(i_got[r].tolist()), r
        ref = dict(zip(i_ref[r].tolist(), s_ref[r].tolist()))
        for i, s in zip(i_got[r].tolist(), s_got[r].tolist()):
            assert abs(ref[i] - s) <= atol, (r, i, ref[i], s)
        moved = i_ref[r] != i_got[r]
        np.testing.assert_allclose(s_got[r][moved], s_ref[r][moved], rtol=0, atol=tie)


def assert_beams_in_order(s_ref, i_ref, s_got, i_got, atol=0.0):
    """The same ids in the same order, and scores within ``atol``."""
    np.testing.assert_array_equal(np.asarray(i_got), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(s_got), np.asarray(s_ref), rtol=0, atol=atol)



def clustered_rows(n=1500, d=64, n_centers=48, spread=0.1, seed=0):
    """Unit rows around ``n_centers`` tight centres: k-means boundaries fall
    between clusters, so rounding differences between the packages cannot
    flip an assignment."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    x = centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal((n, d))
    x = x.astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def substitute_jax_fits(monkeypatch):
    """Route every fit that draws randomness in the port's PQ family through
    the JAX package's own: the subspace k-means of ``ops.pq`` (JAX's
    ``kmeans_fit`` a subspace, as JAX's ``pq_train`` loops), OPQ's
    training in the builders (``index.pq.fit_and_encode`` for PQ and
    HNSW-PQ, ``index.ivfpq``), and IVF's training sample and coarse fit.
    Everything downstream of the fits is then the port's own code."""
    import jax
    import jax.numpy as jnp
    import torch

    from image_search_engine_for_historical_research_tpu.ops import kmeans as jkm
    from image_search_engine_for_historical_research_tpu.ops import pq as jpq
    from image_search_engine_for_historical_research_tpu_torch.index import ivfpq as tivf
    from image_search_engine_for_historical_research_tpu_torch.index import pq as tipq
    from image_search_engine_for_historical_research_tpu_torch.ops import pq as tpq

    def subspace_fits(fit_vecs, Ks, iters, seed, M, matmul_dtype=None, init="kmeans++"):
        x = jnp.asarray(fit_vecs.cpu().numpy())
        ds = x.shape[1] // M
        keys = jax.random.split(jax.random.PRNGKey(seed), M)
        fits = [jkm.kmeans_fit(x[:, m * ds:(m + 1) * ds], Ks, iters, keys[m], init=init,
                               matmul_dtype=None if matmul_dtype is None else jnp.bfloat16)[0]
                for m in range(M)]
        return torch.as_tensor(np.stack([np.asarray(c) for c in fits]), device=fit_vecs.device)

    def opq_train(vecs, M=16, Ks=256, iters=20, opq_iters=10, seed=42, train_sample=None):
        cb = jpq.opq_train(jnp.asarray(vecs.cpu().numpy()), M=M, Ks=Ks, iters=iters,
                           opq_iters=opq_iters, seed=seed, train_sample=train_sample)
        return tpq.PQCodebook.from_numpy(cb.codewords, cb.rotation, device=vecs.device)

    def train_sample(N, n_train, seed):
        return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), N, shape=(n_train,),
                                            replace=False))

    def coarse_fit(sample, nlist, iters, seed):
        c, _ = jkm.kmeans_fit(jnp.asarray(sample.cpu().numpy()), nlist, iters,
                              jax.random.PRNGKey(seed))
        return torch.as_tensor(np.asarray(c), device=sample.device)

    monkeypatch.setattr(tpq, "_subspace_fits", subspace_fits)
    for mod in (tipq, tivf):
        monkeypatch.setattr(mod, "opq_train", opq_train)
    monkeypatch.setattr(tivf, "_train_sample", train_sample)
    monkeypatch.setattr(tivf, "_coarse_fit", coarse_fit)


def assert_same_arrays(ref: dict, got: dict, atol=1e-5, skip=()):
    """Two artifacts' arrays: the same names, dtypes and shapes; floats
    within ``atol``, integers equal."""
    assert set(ref) == set(got), set(ref) ^ set(got)
    for name in ref:
        if name in skip:
            continue
        a, b = np.asarray(ref[name]), np.asarray(got[name])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (name, a.dtype, b.dtype, a.shape,
                                                          b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def assert_same_ranks(s_ref, i_ref, s_got, i_got, tie=1e-5):
    """The same scores rank by rank (``tie``, relative), and the same ids
    except where an id's score ties (within ``tie``) with a neighbouring
    rank's, or sits at the last rank, where a tie may reach past the list."""
    s_ref, i_ref = np.asarray(s_ref, np.float64), np.asarray(i_ref)
    s_got, i_got = np.asarray(s_got, np.float64), np.asarray(i_got)
    assert i_ref.shape == i_got.shape
    with np.errstate(invalid="ignore"):
        scale = np.where(np.isfinite(s_ref), np.maximum(np.abs(s_ref), 1.0), 1.0)
        diff = np.where(s_got == s_ref, 0.0, np.abs(s_got - s_ref))
    np.testing.assert_array_less(diff, tie * scale + 1e-12)
    k = i_ref.shape[1]
    for r, p in zip(*np.nonzero(i_ref != i_got)):
        near = [j for j in (p - 1, p + 1) if 0 <= j < k]
        tied = any(s_ref[r, j] == s_ref[r, p] or abs(s_ref[r, j] - s_ref[r, p]) <= tie * scale[r, p]
                   for j in near)
        assert tied or p == k - 1, (r, p, i_ref[r, p], i_got[r, p], s_ref[r])


def jax_forest_draws(seed, n_trees, tree, level, N, n_segs, D):
    """JAX's random draws of one RP-forest tree level
    (``index/rpforest.py:42-60, :106-108, :286``), for the port's
    ``index.rpforest._level_draws`` seam: the tree's key from
    ``split(PRNGKey(seed), n_trees)``, then one ``key, sub = split(key)`` a
    level and ``k1, k2 = split(sub)``."""
    import jax
    import torch

    key = jax.random.split(jax.random.PRNGKey(seed), n_trees)[tree]
    for _ in range(level + 1):
        key, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return (torch.from_numpy(np.array(jax.random.uniform(k1, (N,)))),
            torch.from_numpy(np.array(jax.random.uniform(k2, (N,)))),
            torch.from_numpy(np.array(jax.random.normal(k2, (n_segs, D)))))
