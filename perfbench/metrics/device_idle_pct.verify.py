"""Share of the traced window in which no operation ran on the device
(``torch.profiler``'s device events, merged)."""

from perfbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
