"""linkerd CLI: ``python -m linkerd_tpu_torch [--device cpu]
path/to/config.yaml``: the counterpart of ``linkerd_tpu/__main__.py``.

Reference parity: linkerd/main/.../Main.scala:25-49 — load config, build the
linker, serve admin + routers + telemeters, await signals, drain gracefully.

The telemeters run on the CUDA device; ``--device cpu`` runs them on the
CPU (the plain PyTorch path). With no CUDA device and no ``--device
cpu`` the CLI exits non-zero before serving anything: it does not fall
back to the CPU.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys
from typing import List, Optional, Tuple

from linkerd_tpu_torch.admin.server import AdminServer
from linkerd_tpu_torch.linker import DEFAULT_ADMIN_PORT, load_linker

log = logging.getLogger("linkerd_tpu_torch")

USAGE = "usage: python -m linkerd_tpu_torch [--device cpu] <config.yaml>"


async def amain(config_text: str, device: Optional[str] = None) -> None:
    linker = load_linker(config_text, device=device)
    await linker.start()

    admin_spec = linker.spec.admin
    admin = AdminServer(
        linker.metrics, linker.config_dict,
        host=admin_spec.ip if admin_spec else "127.0.0.1",
        port=admin_spec.port if admin_spec else DEFAULT_ADMIN_PORT)
    from linkerd_tpu_torch.admin.handlers import linkerd_admin_handlers
    admin.add_handlers(linkerd_admin_handlers(linker))
    for t in linker.telemeters:
        admin.add_handlers(t.admin_handlers())
    await admin.start()

    identifier_server = None
    if admin_spec is not None and admin_spec.httpIdentifierPort is not None:
        from linkerd_tpu_torch.admin.handlers import mk_identifier_server
        identifier_server = await mk_identifier_server(
            linker, admin_spec.httpIdentifierPort, host=admin_spec.ip)
        log.info("identifier debug server on %s:%s", admin_spec.ip,
                 identifier_server.bound_port)

    from linkerd_tpu_torch.core.tasks import monitor
    telemeter_tasks = [
        monitor(asyncio.create_task(t.run()),
                what=f"telemeter-{type(t).__name__}")
        for t in linker.telemeters]

    # usage telemetry is opt-out (ref: Linker.scala:116-125 implicit
    # telemeters; disable with `usage: {enabled: false}`)
    usage_cfg = linker.spec.usage or {}
    if usage_cfg.get("enabled", True):
        from linkerd_tpu_torch.telemetry.usage import UsageDataTelemeter
        usage = UsageDataTelemeter(
            linker.spec, orgId=str(usage_cfg.get("orgId", "")))
        log.info("anonymized usage telemetry enabled -> %s "
                 "(disable with `usage: {enabled: false}`)",
                 usage._host)
        telemeter_tasks.append(monitor(asyncio.create_task(usage.run()),
                                       what="telemeter-usage"))

    for r in linker.routers:
        log.info("router %s serving on %s", r.label, r.server_ports)
    log.info("admin serving on %s:%s", admin.host, admin.bound_port)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()

    log.info("shutting down")
    for task in telemeter_tasks:
        task.cancel()
    if identifier_server is not None:
        await identifier_server.close()
    await admin.close()
    await linker.close()


def parse_args(argv: List[str]) -> Tuple[Optional[str], str]:
    """``[--device cpu] <config.yaml>`` -> (device, config path); exits
    64 with the usage line on anything else."""
    device = None
    if len(argv) == 3 and argv[0] == "--device":
        device, argv = argv[1], argv[2:]
    if len(argv) != 1 or argv[0].startswith("--"):
        print(USAGE, file=sys.stderr)
        raise SystemExit(64)
    return device, argv[0]


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    device, path = parse_args(sys.argv[1:])
    if device is None:
        import torch
        if not torch.cuda.is_available():
            print("linkerd_tpu_torch: no CUDA device is available; pass "
                  "--device cpu to run the telemeters on the CPU",
                  file=sys.stderr)
            raise SystemExit(1)
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    asyncio.run(amain(text, device=device))


if __name__ == "__main__":
    main()
