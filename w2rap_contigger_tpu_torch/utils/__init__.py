"""Host utilities of the port (copied from w2rap_contigger_tpu/utils)."""
