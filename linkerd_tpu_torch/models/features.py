"""Feature layout constants (copy of ``linkerd_tpu/models/features.py``).

Only the width is needed by the scoring path: a request's feature row
is ``FEATURE_DIM`` float32 values, built by the router side.
"""

FEATURE_DIM = 36
