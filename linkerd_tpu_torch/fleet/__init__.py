"""Fleet coordination on the port: so far the scorer replica pool alone
(``scorer_pool``). The reference's package also holds the fleet digest,
its exchange through namerd, the gossip endpoints and the regions
(``doc``, ``exchange``, ``gossip``, ``regions``), which come with
``control.fleet`` (ROADMAP Queue 1 item 14)."""

from linkerd_tpu_torch.fleet.scorer_pool import (  # noqa: F401
    ScorerReplicaPool,
)
