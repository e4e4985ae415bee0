"""namerd CLI: ``python -m linkerd_tpu_torch.namerd path/to/namerd.yaml``:
the counterpart of ``linkerd_tpu/namerd/__main__.py`` over the port's
``namerd/config.py``, which serves the HTTP control, gRPC mesh and
thrift name interpreter interfaces and refuses the reference's remote
stores by name. namerd does no device work.

Ref: namerd/main/src/main/scala/io/buoyant/namerd/Main.scala:10-55 — load
config, serve admin + interfaces, await signals.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from linkerd_tpu_torch.namerd.config import NamerdProcess, parse_namerd_spec
from linkerd_tpu_torch.config.parser import parse_config

log = logging.getLogger("linkerd_tpu_torch.namerd")


async def amain(config_text: str) -> None:
    spec = parse_namerd_spec(config_text)
    proc = NamerdProcess(spec, parse_config(config_text))
    await proc.start()
    for cfg, server in zip(proc._iface_cfgs, proc.servers):
        log.info("namerd iface %s serving on %s:%s",
                 cfg.kind, cfg.ip, server.bound_port)
    if proc.admin_server is not None:
        log.info("admin serving on %s", proc.admin_server.bound_port)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    log.info("shutting down")
    await proc.close()


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    if len(sys.argv) != 2:
        print("usage: python -m linkerd_tpu_torch.namerd <config.yaml>",
              file=sys.stderr)
        raise SystemExit(64)
    with open(sys.argv[1], "r", encoding="utf-8") as f:
        text = f.read()
    asyncio.run(amain(text))


if __name__ == "__main__":
    main()
