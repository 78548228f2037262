"""CPU tests of the benchmark's own code (``python -m pytest perfbench/tests``);
tests marked ``cuda`` run on the card and skip elsewhere."""
