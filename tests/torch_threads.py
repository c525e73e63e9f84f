"""One torch thread a test process, for the port's CPU test modules, which
import this module for that alone. The suite runs under pytest-xdist, a
process a core, and torch's default pool of a thread a core in each
process oversubscribes the cores (twice the wall time)."""
import torch

torch.set_num_threads(1)
