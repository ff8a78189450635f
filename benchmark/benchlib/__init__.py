"""The benchmark's own library: cells, phantoms, weights, arithmetic, traces
and the comparison that decides ``correct``. Nothing here imports the
program at module level; ``harness`` imports it inside the run."""
