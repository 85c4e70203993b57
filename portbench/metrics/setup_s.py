"""setup_s: from the start of the run to the window's opening: data made
from the seed, the index built, the kernels built or loaded and warmed
(host clock)."""


def read(rec):
    return rec.setup_s
