"""Override verification for the mesh reactor: what
``linkerd_tpu/control/reactor.py``'s ``verify_override`` reaches in
l5dcheck, from the port's copy of its dtab analysis
(``linkerd_tpu_torch/check/dtab_check.py``): the probe namers and the
symbolic delegation they drive, the prefix algebra and
``check_override``, the ``override-unsafe`` rule."""

from linkerd_tpu_torch.check.dtab_check import (  # noqa: F401
    PROBE_SEG, DtabAnalysis, ProbeNamer, check_override, dst_leaf_paths,
    prefix_subsumes, probe_interpreter, probe_path_for, terminals,
)
