"""The router pieces the telemeter needs: a copy of parts of
``linkerd_tpu/router``."""
