"""The JAX package's host modules that the port reuses, in one place.

None of them imports jax (each imports with sys.modules['jax'] = None;
tests/test_torch_slice.py checks the whole port that way).  They are
reused, not copied: FASTQ loading (step 1), the HBV and ReadPathVec
checkpoint classes, path extension, validation, the numpy kmer word
operations for host code, the TIMELOG timers and the g++ loader of the
host C++ leaves.
"""

from w2rap_contigger_tpu import config, native  # noqa: F401
from w2rap_contigger_tpu.__main__ import ALLOWED_K  # noqa: F401
from w2rap_contigger_tpu.core.io_fastq import extract_reads  # noqa: F401
from w2rap_contigger_tpu.core.reads import ReadSet  # noqa: F401
from w2rap_contigger_tpu.graph import validate  # noqa: F401
from w2rap_contigger_tpu.graph.hbv import HyperBasevector  # noqa: F401
from w2rap_contigger_tpu.ops import bitkmer as np_bitkmer  # noqa: F401
from w2rap_contigger_tpu.paths import extend  # noqa: F401
from w2rap_contigger_tpu.paths.read_paths import ReadPathVec  # noqa: F401
from w2rap_contigger_tpu.utils import sysinfo  # noqa: F401
