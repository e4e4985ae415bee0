"""Protocol message models: a copy of parts of ``linkerd_tpu/protocol``."""
