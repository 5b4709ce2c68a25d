"""w2rap_contigger_tpu_torch — the PyTorch + CUDA port of w2rap_contigger_tpu.

The JAX package (`w2rap_contigger_tpu`) is the reference this port is
held against; module names mirror it (`ops/`, `graph/`, `paths/`,
`pipeline/`) so every module has an obvious counterpart.  The port runs
step 2 (buildReadQGraph: small-k count, unitig graph, read paths) and
step 3 (RepathInMemory: the large-K graph and the translated read paths)
on an NVIDIA H100; the other steps are not ported yet (see ROADMAP.md).

The host code the port needs (FASTQ loading in `core/`, the HBV and
ReadPathVec checkpoint classes, path extension, validation, the numpy
kmer words in `ops/np_bitkmer.py`, the TIMELOG timers in `utils/`, the
g++ loader of the host C++ leaves in `native/`) is copied from the JAX
package under the same relative names.  Nothing here imports jax or the
JAX package.

u32 convention.  torch.uint32 lacks `<`, shifts, `~`, `+` and
searchsorted, so:

* plain torch code holds kmer word planes as int64 tensors carrying
  u32 values in [0, 2**32);
* the CUDA kernels take raw 32-bit memory: torch.int32 tensors whose
  bits are the u32 words (`ops.bitkmer.to_raw32` / `from_raw32`
  convert);
* two words pack into one order-preserving int64 sort key as
  ((w0 ^ 0x80000000) << 32) | w1 — the sign flip makes signed int64
  order equal unsigned (w0, w1) order.

The device is always explicit: every entry takes a `device` (or works
on its tensors' device); asking for cuda without a card raises.
"""

__version__ = "0.1.0"

SMALL_K = 60  # the hard-coded small k (reference: src/modules/w2rap-contigger.cc:132)
