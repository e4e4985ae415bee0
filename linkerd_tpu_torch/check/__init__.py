"""l5dcheck's semantic config check on the port: the counterpart of the
repo's ``tools/analysis/semantic``, which imports the JAX package.

Dtabs are evaluated by symbolic delegation over the port's own
``DelegateTree``/``ConfiguredDtabNamer``, router wiring is cross-checked
(port conflicts, timeout inversions, starved retry budgets, admission
bounds against deadline budgets, missing TLS material) and the
``io.l5d.jaxAnomaly`` block is validated against the model and lifecycle
contracts, with the port's parsers and kind registry. The admin
server's ``/config-check.json`` runs it on the live linker's config.

Suppress inline with ``# l5d: ignore[rule] — why`` in YAML comments.
"""

from linkerd_tpu_torch.check.engine import (  # noqa: F401
    check_data, check_file, check_text, semantic_rule_ids,
)
from linkerd_tpu_torch.check.loader import ConfigSource  # noqa: F401
