"""Asyncio ZooKeeper client and the components built on it.

One shared client (jute wire protocol, watches, session keepalive,
reconnect) backs the five ZK-family components the reference ships:
the io.l5d.serversets / io.l5d.zkLeader / io.l5d.curator namers
(namer/serversets, namer/zk-leader, namer/curator), the io.l5d.zk dtab
store (namerd/storage/zk), and the io.l5d.serversets announcer
(linkerd/announcer/serversets).
"""

from linkerd_tpu_torch.zk.client import (  # noqa: F401
    Stat, WatchEvent, ZkClient, ZkError,
    ZK_BADVERSION, ZK_CONNECTIONLOSS, ZK_NONODE, ZK_NODEEXISTS,
)
