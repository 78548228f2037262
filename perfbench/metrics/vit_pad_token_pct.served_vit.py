"""``vit_pad_token_pct.served_vit``: the share of the ViT's token rows
that were computed but were no key, ``100 (rows - keys) / rows``, from the
port's counters ``vit.token_rows`` and ``vit.key_rows`` summed over the
traced window (every row of every batch slot counts as computed). None
untraced, or on a port without the counters."""


def read(rec):
    if not rec.get("trace"):
        return None
    try:
        from image_search_engine_for_historical_research_tpu_torch.utils import tracing

        counts = tracing.counters()
    except (ImportError, AttributeError):
        return None
    rows, keys = counts.get("vit.token_rows"), counts.get("vit.key_rows")
    if not rows or keys is None:
        return None
    return 100.0 * (rows - keys) / rows
