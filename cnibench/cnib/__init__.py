"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

Everything here is the yardstick: the traffic generator, the plain
reference, the comparison that decides ``correct`` and the profiler
arithmetic.  The program under test is reached only through
``repro_torch.serve.GraphQueryService``, its spans (``repro_torch.obsv``)
and the kernel names in the profiler's trace.
"""

import numpy as np


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run: the same
    ``(seed, stream)`` always gives the same number, and different streams
    give independent ones.  Any whole ``seed`` is accepted."""
    words = [int(seed) % (1 << 64)] + [ord(c) for c in stream]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) >> 1
