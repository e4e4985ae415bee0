"""The port's reactive control loop (``linkerd_tpu_torch/control/``)
against the JAX package's on the same inputs, on the CPU.

- ``HysteresisGovernor``: seeded observation sequences give the same
  states and ``snapshot()`` after every observation.
- ``mk_weigher`` / ``ScoreWeightedBalancer``: boards fed the same rows
  give the same weights and the same ``weights()``.
- ``AdaptiveAdmission``: the same board and drift sequences give the
  same factor sequence and the same ``AdmissionControlFilter`` limits.
- ``check_override``: the port's copy (``control/verify.py``) gives
  l5dcheck's findings, messages word for word, on a table of cases.
- ``MeshReactor`` on ``InMemoryDtabStore`` with scripted board levels
  and ``step(now=...)``: the same store dtabs, counters and ``status()``
  after every step, in seven scenarios.
- ``ControlConfig``: the reference's keys and defaults; ``fleet`` and
  ``regionFailover`` refused by name; ``ControlLoop.status()`` equal.
- End to end: a linker with ``control:``, ``admissionControl`` and
  ``interpreter: {kind: io.l5d.namerd.http}`` bound through a namerd of
  its own package; scores scripted per batch. The override is published,
  traffic moves to the ``-b`` cluster, the override reverts, and an
  oscillation publishes nothing more: both packages publish and revert
  the same number of overrides and end with the same namespace bytes.

Every await is bounded.
"""

import asyncio
import dataclasses
import random
import time

import numpy as np
import pytest

from linkerd_tpu import control as ref_control
from linkerd_tpu.control import admission as ref_admission
from linkerd_tpu.control import balancer as ref_balancer
from linkerd_tpu.control import loop as ref_loop
from linkerd_tpu.control import reactor as ref_reactor
from linkerd_tpu.control import state as ref_state
from linkerd_tpu import core as ref_core
from linkerd_tpu.core import addr as ref_addr
from linkerd_tpu import namerd as ref_namerd
from linkerd_tpu.router import admission as ref_radmission
from linkerd_tpu.router import balancer as ref_rbalancer
from linkerd_tpu.router import service as ref_service
from linkerd_tpu.telemetry import anomaly as ref_anomaly
from linkerd_tpu.telemetry import metrics as ref_metrics
from linkerd_tpu_torch import control as port_control
from linkerd_tpu_torch.config import ConfigError, instantiate
from linkerd_tpu_torch.config.parser import ConfigRefused
from linkerd_tpu_torch.control import admission as port_admission
from linkerd_tpu_torch.control import balancer as port_balancer
from linkerd_tpu_torch.control import loop as port_loop
from linkerd_tpu_torch.control import reactor as port_reactor
from linkerd_tpu_torch.control import state as port_state
from linkerd_tpu_torch.control import verify as port_verify
from linkerd_tpu_torch import core as port_core
from linkerd_tpu_torch.core import addr as port_addr
from linkerd_tpu_torch import namerd as port_namerd
from linkerd_tpu_torch.router import admission as port_radmission
from linkerd_tpu_torch.router import balancer as port_rbalancer
from linkerd_tpu_torch.router import service as port_service
from linkerd_tpu_torch.telemetry import anomaly as port_anomaly
from linkerd_tpu_torch.telemetry import metrics as port_metrics

# one namespace of modules per package, so each scenario is written once
REF = dict(state=ref_state, balancer=ref_balancer, admission=ref_admission,
           reactor=ref_reactor, loop=ref_loop, core=ref_core, addr=ref_addr,
           namerd=ref_namerd, radmission=ref_radmission,
           rbalancer=ref_rbalancer, service=ref_service,
           anomaly=ref_anomaly, metrics=ref_metrics)
PORT = dict(state=port_state, balancer=port_balancer,
            admission=port_admission, reactor=port_reactor, loop=port_loop,
            core=port_core, addr=port_addr, namerd=port_namerd,
            radmission=port_radmission, rbalancer=port_rbalancer,
            service=port_service, anomaly=port_anomaly,
            metrics=port_metrics)


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def both(fn):
    """``fn(pkg)`` for the reference, then the port."""
    return fn(REF), fn(PORT)


class FakeBoard:
    """Scripted per-cluster levels (the reference test's _FakeBoard)."""

    def __init__(self):
        self.levels = {}
        self.degraded = False

    def effective_scores(self):
        return dict(self.levels)

    def anomaly_level(self):
        return max(self.levels.values(), default=0.0)


def test_public_names_match():
    assert sorted(port_control.__all__) == sorted(ref_control.__all__)


# -- governor ----------------------------------------------------------------

GOVERNORS = {"defaults": {}, "tight": dict(enter=0.6, exit=0.2, quorum=1,
                                           dwell_s=0.0),
             "e2e": dict(enter=0.6, exit=0.2, quorum=2, dwell_s=0.1),
             "slow": dict(enter=0.8, exit=0.4, quorum=3, dwell_s=0.5)}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("params", sorted(GOVERNORS))
def test_governor_transitions_match(params, seed):
    rng = np.random.default_rng(seed)
    keys = ["/svc/a", "/svc/b", "/svc/c"]
    # runs of calm, sick and oscillating levels, 40 ms apart
    levels = np.concatenate([rng.uniform(lo, hi, 40) for lo, hi in (
        (0.0, 0.3), (0.65, 1.0), (0.0, 1.0), (0.0, 0.15), (0.7, 1.0))])
    # every key each tick, the second and third damped and jittered
    obs = [(k, float(np.clip(lv * d + rng.normal(0, 0.05), 0, 1)), 0.04 * i)
           for i, lv in enumerate(levels)
           for k, d in zip(keys, (1.0, 0.9, 0.6))]

    def trace(pkg):
        g = pkg["state"].HysteresisGovernor(**GOVERNORS[params])
        out = [(g.observe(k, lv, now=t), g.snapshot()) for k, lv, t in obs]
        g.forget("/svc/c")
        return out, g.keys(), g.state_of("/svc/c")

    ref, port = both(trace)
    assert port == ref
    assert sum(s["transitions"] for s in ref[0][-1][1].values()) > 0


def test_governor_rejects_what_the_reference_rejects():
    for kw in (dict(enter=0.3, exit=0.7), dict(quorum=0),
               dict(dwell_s=-1.0)):
        errs = []
        for pkg in (REF, PORT):
            with pytest.raises(ValueError) as e:
                pkg["state"].HysteresisGovernor(**kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# -- balancer weighting ------------------------------------------------------

def fed_board(pkg, rows, ttl_s=None):
    board = pkg["anomaly"].ScoreBoard(alpha=0.3, ttl_s=ttl_s)
    for dsts, scores, eps in rows:
        board.update_batch(dsts, np.asarray(scores, np.float32),
                           endpoints=eps)
    return board


def board_rows(seed: int, n_eps: int = 6, batches: int = 12):
    rng = np.random.default_rng(seed)
    eps = [f"127.0.0.1:{8000 + i}" for i in range(n_eps)]
    sick = {eps[0]: 0.95, eps[1]: 0.6}
    rows = []
    for _ in range(batches):
        pick = [eps[int(i)] for i in rng.integers(n_eps, size=32)]
        scores = [float(np.clip(sick.get(e, 0.1) + rng.normal(0, 0.05),
                                0, 1)) for e in pick]
        rows.append((["/svc/web"] * 32, scores, pick))
    return eps, rows


@pytest.mark.parametrize("threshold,floor", [(0.3, 0.05), (0.5, 0.2),
                                             (0.1, 0.5)])
def test_weigher_and_balancer_weights_match(threshold, floor):
    eps, rows = board_rows(1)

    def weights(pkg):
        board = fed_board(pkg, rows)
        w = pkg["balancer"].mk_weigher(board, threshold, floor)
        addrs = [pkg["addr"].Address.mk("127.0.0.1", 8000 + i)
                 for i in range(len(eps))]
        bal = pkg["rbalancer"].P2CBalancer(
            pkg["core"].Var(pkg["addr"].Bound(frozenset(addrs))),
            lambda a: pkg["service"].FnService(None),
            rng=random.Random(7))
        swb = pkg["balancer"].ScoreWeightedBalancer(bal, w)
        return ([w(e) for e in eps + ["unknown:1"]], swb.weights(),
                swb.size)

    ref, port = both(weights)
    assert port == ref
    assert min(ref[0]) == pytest.approx(max(floor, ref[0][0]))
    assert ref[0][-1] == 1.0 and ref[0][0] < 1.0


def test_degraded_board_weighs_neutral_in_both():
    eps, rows = board_rows(2)

    def weights(pkg):
        board = fed_board(pkg, rows)
        board.degraded = True
        w = pkg["balancer"].mk_weigher(board)
        return [w(e) for e in eps]

    ref, port = both(weights)
    assert port == ref == [1.0] * len(eps)


# -- adaptive admission --------------------------------------------------------

class ScriptedDrift:
    def __init__(self, shifts):
        self._shifts = iter(shifts)
        self.value = 0.0

    def advance(self):
        self.value = next(self._shifts)

    def score_shift(self):
        return self.value


@pytest.mark.parametrize("seed", range(3))
def test_adaptive_admission_factors_match(seed):
    rng = np.random.default_rng(seed)
    levels = np.concatenate([rng.uniform(0, 0.4, 10), rng.uniform(0.6, 1, 15),
                             rng.uniform(0, 0.3, 15)])
    shifts = np.concatenate([np.zeros(20), rng.uniform(0, 6, 20)])

    def factors(pkg):
        board = pkg["anomaly"].ScoreBoard(alpha=0.3, ttl_s=None)
        drift = ScriptedDrift(shifts.tolist())
        metrics = pkg["metrics"].MetricsTree()
        adm = pkg["admission"].AdaptiveAdmission(
            board, drift=drift, threshold=0.5, floor=0.25, alpha=0.3,
            metrics_node=metrics.scope("control", "admission"))
        filters = [pkg["radmission"].AdmissionControlFilter(n, 0)
                   for n in (256, 7)]
        for f in filters:
            adm.register(f)
        out = []
        for lv in levels:
            board.update_batch(["/svc/a", "/svc/b"],
                               np.array([lv, lv / 2], np.float32))
            drift.advance()
            out.append((adm.step(), [f.effective_concurrency
                                     for f in filters], adm.status()))
        return out, metrics.flatten()

    ref, port = both(factors)
    assert port == ref
    lowest = min(f for f, _, _ in ref[0])
    assert 0.25 <= lowest < 0.6
    assert min(lim[0] for _, lim, _ in ref[0]) >= 64   # floor x 256


# -- override verification ------------------------------------------------------

VERIFY_CASES = {
    "clean": ("/svc => /#/io.l5d.fs ;", "/svc/web => /svc/web-b ;",
              ["/io.l5d.fs"]),
    "self-shift cycle": ("/svc => /#/io.l5d.fs ;", "/svc/web => /svc/web ;",
                         ["/io.l5d.fs"]),
    "alias cycle": ("/svc => /#/io.l5d.fs ; /svc/b => /svc/web ;",
                    "/svc/web => /svc/b ;", ["/io.l5d.fs"]),
    "unbound target": ("/svc => /#/io.l5d.fs ;",
                       "/svc/web => /#/io.l5d.nope/x ;", ["/io.l5d.fs"]),
    "neg target": ("/svc => /#/io.l5d.fs ;", "/svc/web => ~ ;",
                   ["/io.l5d.fs"]),
    "wildcard prefix": ("/svc => /#/io.l5d.fs ;", "/svc/* => /svc/web-b ;",
                        ["/io.l5d.fs"]),
    "collateral shadowing": (
        "/svc => /#/io.l5d.fs ; /svc/special => /#/io.l5d.fs/sp ;",
        "/svc => /svc/web-b ;", ["/io.l5d.fs"]),
    "unknown namers, clean": ("/svc => /#/io.l5d.fs ;",
                              "/svc/web => /#/anything/x ;", None),
    "unknown namers, cycle": ("/svc => /#/io.l5d.fs ;",
                              "/svc/web => /svc/web ;", None),
    "no namers": ("/svc => /#/io.l5d.fs ;", "/svc/web => /svc/web-b ;", []),
    "two dentries": ("/svc => /#/io.l5d.fs ;",
                     "/svc/a => /svc/a ; /svc/* => /#/io.l5d.nope ;",
                     ["/io.l5d.fs"]),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_check_override_matches_l5dcheck(case):
    from tools.analysis.semantic.dtab_check import check_override

    base, override, prefixes = VERIFY_CASES[case]

    def findings(core, fn):
        ps = None if prefixes is None else [core.Path.read(p)
                                            for p in prefixes]
        return [(f.rule, f.path, f.line, f.col, f.message, f.severity,
                 f.suppressed) for f in fn(
                    core.Dtab.read(base), core.Dtab.read(override), ps)]

    ref = findings(ref_core, check_override)
    port = findings(port_core, port_verify.check_override)
    assert port == ref
    assert bool(ref) == (case not in ("clean", "unknown namers, clean"))
    # and the reactor's verifier reads the same messages
    ps = None if prefixes is None else [port_core.Path.read(p)
                                        for p in prefixes]
    assert port_reactor.verify_override(
        port_core.Dtab.read(base), port_core.Dtab.read(override), ps) == \
        [m for _, _, _, _, m, _, _ in ref]


# -- the mesh reactor ---------------------------------------------------------

BASE_DTAB = "/svc => /#/io.l5d.fs ;"


def mk_reactor(pkg, store, board, client=None, failover=None, quorum=1,
               dwell=0.0, metrics=None, **kw):
    node = (metrics or pkg["metrics"].MetricsTree()).scope(
        "control", "reactor")
    kw.setdefault("namer_prefixes", [pkg["core"].Path.read("/io.l5d.fs")])
    return pkg["reactor"].MeshReactor(
        board, client or pkg["reactor"].LocalStoreClient(store), "default",
        failover or {"/svc/web": "/svc/web-b"},
        governor=pkg["state"].HysteresisGovernor(
            enter=0.6, exit=0.2, quorum=quorum, dwell_s=dwell),
        metrics_node=node, **kw)


async def ns_show(store) -> str:
    vd = await asyncio.wait_for(store.observe("default").to_future(), 5)
    return vd.dtab.show


def reactor_flat(metrics) -> dict:
    return {k: v for k, v in metrics.flatten().items()
            if k.startswith("control/reactor/")}


async def scripted(pkg, steps, store=None, client_cls=None, **kw):
    """Drive a reactor through ``steps`` of (now, {cluster: level});
    returns the namespace dtab, counters and status after each step."""
    store = store or pkg["namerd"].InMemoryDtabStore(
        {"default": pkg["core"].Dtab.read(BASE_DTAB)})
    board, metrics = FakeBoard(), pkg["metrics"].MetricsTree()
    client = client_cls(pkg, store) if client_cls is not None else None
    r = mk_reactor(pkg, store, board, client=client, metrics=metrics, **kw)
    out = []
    for now, levels in steps:
        board.levels.update(levels)
        await asyncio.wait_for(r.step(now=now), 5)
        out.append((await ns_show(store), reactor_flat(metrics),
                    r.status()))
    return out


def trip_steps():
    return ([(1.0, {"/svc/web": 0.9}), (2.0, {"/svc/web": 0.95}),
             (3.0, {"/svc/web": 0.0}), (4.0, {"/svc/web": 0.1})])


def oscillation_steps():
    return [(0.05 * i, {"/svc/web": 0.9 if i % 2 == 0 else 0.1})
            for i in range(100)]


def racing_client(pkg, store):
    """An operator write lands between the reactor's fetch and cas."""

    class Racing(pkg["reactor"].LocalStoreClient):
        race_once = True

        async def fetch(self, ns):
            vd = await super().fetch(ns)
            if self.race_once:
                self.race_once = False
                await store.put(ns, pkg["core"].Dtab.read(
                    BASE_DTAB + " /ops => /#/io.l5d.fs/ops ;"))
            return vd

    return Racing(store)


def hung_client(pkg, store):
    class Hung:
        async def fetch(self, ns):
            await asyncio.Event().wait()  # forever; cancellable

        async def cas(self, ns, dtab, version):
            pass

        async def aclose(self):
            pass

    return Hung()


REACTOR_CASES = {
    "trip, publish, revert": dict(steps=trip_steps),
    "oscillation": dict(steps=oscillation_steps, quorum=3, dwell=0.5),
    "operator write wins the cas": dict(
        steps=lambda: [(1.0, {"/svc/web": 0.9}), (2.0, {"/svc/web": 0.9}),
                       (3.0, {"/svc/web": 0.0})],
        client_cls=racing_client),
    "hung store": dict(steps=lambda: [(1.0, {"/svc/web": 0.9})],
                       client_cls=hung_client, store_timeout_s=0.05),
    "rejected override": dict(
        steps=lambda: [(1.0, {"/svc/web": 0.9}), (2.0, {"/svc/web": 0.9}),
                       (3.0, {"/svc/web": 0.0})],
        failover={"/svc/web": "/#/io.l5d.nope/x"}),
    "unsafe self-shift with unknown namers": dict(
        steps=lambda: [(1.0, {"/svc/web": 0.9})],
        failover={"/svc/web": "/svc/web"}, namer_prefixes=None),
    # a failover key equal to a base dentry's prefix: the reactor adopts
    # the operator's dentry as a peer's override and its revert deletes
    # it, in both packages (ROADMAP Queue 3, reference side)
    "failover key equal to a base prefix": dict(
        steps=lambda: [(1.0, {"/svc/web": 0.9}), (2.0, {"/svc/web": 0.0})],
        failover={"/svc": "/svc/web-b"}),
}


@pytest.mark.parametrize("case", sorted(REACTOR_CASES))
def test_reactor_scenarios_match(case):
    spec = dict(REACTOR_CASES[case])
    steps = spec.pop("steps")()

    async def go():
        return (await scripted(REF, steps, **spec),
                await scripted(PORT, steps, **spec))

    ref, port = run(go())
    assert port == ref
    shows = [s for s, _, _ in ref]
    last = ref[-1][1]
    if case == "trip, publish, revert":
        assert "/svc/web => /svc/web-b" in shows[0]
        assert shows[-1] == ref_core.Dtab.read(BASE_DTAB).show
        assert last["control/reactor/overrides_published"] == 1
        assert last["control/reactor/overrides_reverted"] == 1
    elif case == "oscillation":
        assert last["control/reactor/overrides_published"] == 0
        assert set(shows) == {ref_core.Dtab.read(BASE_DTAB).show}
    elif case == "operator write wins the cas":
        assert ref[0][1]["control/reactor/cas_conflicts"] == 1
        assert "/svc/web => /svc/web-b" in shows[1] and "/ops" in shows[1]
        assert "/ops" in shows[-1] and "web-b" not in shows[-1]
    elif case == "failover key equal to a base prefix":
        assert last["control/reactor/overrides_adopted"] == 1
        assert shows == [ref_core.Dtab.read(BASE_DTAB).show, ""]
    elif case == "hung store":
        assert last["control/reactor/partitioned"] == 1.0
        assert last["control/reactor/errors"] == 0
    else:
        assert last["control/reactor/overrides_rejected"] >= 1
        assert last["control/reactor/overrides_published"] == 0
        assert set(shows) == {ref_core.Dtab.read(BASE_DTAB).show}
        assert ref[-1][2]["rejected"] or case == "rejected override"


def test_peer_override_is_adopted_not_duplicated():
    """Two reactors over one store: the second to trip adopts the
    first's dentry; either's revert removes the single dentry."""
    async def go(pkg):
        store = pkg["namerd"].InMemoryDtabStore(
            {"default": pkg["core"].Dtab.read(BASE_DTAB)})
        boards = FakeBoard(), FakeBoard()
        metrics = pkg["metrics"].MetricsTree(), pkg["metrics"].MetricsTree()
        ra, rb = (mk_reactor(pkg, store, b, metrics=m)
                  for b, m in zip(boards, metrics))
        out = []
        for r, b, now, level in ((ra, boards[0], 1.0, 0.9),
                                 (rb, boards[1], 1.0, 0.9),
                                 (rb, boards[1], 2.0, 0.0),
                                 (ra, boards[0], 2.0, 0.0)):
            b.levels["/svc/web"] = level
            await asyncio.wait_for(r.step(now=now), 5)
            out.append((await ns_show(store), reactor_flat(metrics[0]),
                        reactor_flat(metrics[1]), ra.status(),
                        rb.status()))
        return out

    async def both_go():
        return await go(REF), await go(PORT)

    ref, port = run(both_go())
    assert port == ref
    assert ref[1][0].count("/svc/web => /svc/web-b") == 1
    assert ref[1][2]["control/reactor/overrides_adopted"] == 1
    assert "web-b" not in ref[-1][0]


# -- config and the loop ------------------------------------------------------

def test_control_config_keys_and_defaults_match():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(port_loop.ControlConfig) == fields(ref_loop.ControlConfig)
    assert set(port_loop.REFUSED_KEYS) == {"fleet", "regionFailover"}


@pytest.mark.parametrize("key", ["fleet", "regionFailover"])
def test_fleet_keys_refused_by_name(key):
    raw = {"kind": "io.l5d.jaxAnomaly", "control": {
        key: {"instance": "l5d-a"} if key == "fleet"
        else {"/svc/web": {"east": "/svc/web-east"}}}}
    with pytest.raises(ConfigRefused,
                       match=f"'{key}'.*ROADMAP Queue 1 item 14"):
        instantiate("telemeter", raw)
    with pytest.raises(ConfigError, match=f"'{key}'"):
        port_loop.ControlConfig(**{key: {}})


CONTROL_BLOCKS = {
    "defaults": {},
    "reactor": {"namespace": "default", "failover": {"/svc/web": "/svc/web-b"},
                "enterThreshold": 0.6, "exitThreshold": 0.2, "quorum": 2,
                "cooldownS": 0.1, "intervalMs": 20},
    "no actuators": {"balancerWeighting": False, "adaptiveAdmission": False},
}


@pytest.mark.parametrize("block", sorted(CONTROL_BLOCKS))
def test_control_loop_status_and_steps_match(block):
    """The loop built from the same block on boards fed the same rows:
    the same status() before and after steps, warm-up gate included."""
    eps, rows = board_rows(3)
    cfg = CONTROL_BLOCKS[block]

    async def go(pkg, ccls):
        board = fed_board(pkg, rows)
        metrics = pkg["metrics"].MetricsTree()
        batches = [0]
        loop = ccls(**cfg).mk(board, metrics, ready_fn=lambda: batches[0]
                              >= 2)
        store = pkg["namerd"].InMemoryDtabStore(
            {"default": pkg["core"].Dtab.read(BASE_DTAB)})
        if loop.cfg.failover:
            loop.set_store_client(pkg["reactor"].LocalStoreClient(store))
        loop.set_namer_prefixes([pkg["core"].Path.read("/io.l5d.fs")])
        f = pkg["radmission"].AdmissionControlFilter(256, 0)
        loop.register_admission(f)
        out = [loop.status()]
        for i in range(4):
            batches[0] = i
            await asyncio.wait_for(loop.step(), 5)
            out.append((loop.status(), f.effective_concurrency))
        await loop.aclose()
        return out, {k: v for k, v in metrics.flatten().items()
                     if k.startswith("control/")}

    async def both_go():
        return (await go(REF, ref_loop.ControlConfig),
                await go(PORT, port_loop.ControlConfig))

    ref, port = run(both_go())
    assert port == ref
    assert ref[0][-1][0]["warmed_up"] is True
    assert ref[0][1][0]["warmed_up"] is False


def test_control_block_loads_in_the_telemeter():
    """``control:`` on io.l5d.jaxAnomaly builds a ControlLoop gated on
    the telemeter's batches, as the reference's does."""
    raw = {"kind": "io.l5d.jaxAnomaly", "trainEveryBatches": 0,
           "control": {"warmupBatches": 3, "weightFloor": 0.1}}

    def build(pkg):
        from linkerd_tpu.config import instantiate as ref_instantiate
        if pkg is REF:
            return ref_instantiate("telemeter", raw).mk(
                ref_metrics.MetricsTree())
        return instantiate("telemeter", raw).mk(
            port_metrics.MetricsTree(), device="cpu")

    tele_ref, tele_port = both(build)
    try:
        assert isinstance(tele_port.control, port_loop.ControlLoop)
        assert tele_port.control.status() == tele_ref.control.status()
        assert tele_port.control._ready_fn() is False
        tele_port._batches.incr(3)
        assert tele_port.control._ready_fn() is True
    finally:
        tele_ref.close()
        tele_port.close()
    assert tele_port.control._stop.is_set()


# -- end to end: a linker, its namerd, traffic moving ---------------------------

class LevelScorer:
    """Every row scores ``level`` (settable mid-test): the reference
    test's _LevelScorer, driving recorder -> batcher -> board ->
    control loop with no model in the loop."""

    def __init__(self, level: float = 0.0):
        self.level = level
        self.batches = 0

    async def score(self, x):
        self.batches += 1
        return np.full(len(x), self.level, np.float32)

    async def fit(self, x, labels, mask):
        return 0.0

    def snapshot(self):
        raise NotImplementedError

    def close(self):
        pass


def e2e_config(ctl_port: int) -> str:
    return f"""
routers:
- protocol: http
  label: edge
  servers: [{{port: 0}}]
  admissionControl: {{maxConcurrency: 256}}
  interpreter:
    kind: io.l5d.namerd.http
    dst: /$/inet/127.0.0.1/{ctl_port}
    namespace: default
telemetry:
- kind: io.l5d.jaxAnomaly
  maxBatch: 64
  maxLingerMs: 1
  trainEveryBatches: 0
  nativeTier: "off"
  scoreTtlSecs: 10
  control:
    intervalMs: 20
    warmupBatches: 1
    enterThreshold: 0.6
    exitThreshold: 0.2
    quorum: 2
    cooldownS: 0.1
    namespace: default
    namerdAddress: 127.0.0.1:{ctl_port}
    failover:
      /svc/web: /svc/web-b
"""


async def eventually(pred, what: str, tick, timeout: float = 15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        await tick()
        if pred():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


async def e2e(pkg, tmp_path):
    """One linker of ``pkg`` bound through a namerd of ``pkg``: healthy,
    fault (publish, shift), recovery (revert, return), oscillation."""
    if pkg is REF:
        from linkerd_tpu.linker import load_linker
        from linkerd_tpu.namer.fs import FsNamer
        from linkerd_tpu.namerd.http_api import HttpControlService
        from linkerd_tpu.protocol.http import Request, Response
        from linkerd_tpu.protocol.http.client import HttpClient
        from linkerd_tpu.protocol.http.server import HttpServer, serve

        def load(text):
            return load_linker(text)
    else:
        from linkerd_tpu_torch.linker import load_linker
        from linkerd_tpu_torch.namer.fs import FsNamer
        from linkerd_tpu_torch.namerd.http_api import HttpControlService
        from linkerd_tpu_torch.protocol.http.message import Request, Response
        from linkerd_tpu_torch.protocol.http.client import HttpClient
        from linkerd_tpu_torch.protocol.http.server import HttpServer, serve

        def load(text):
            return load_linker(text, device="cpu")

    counts = {"a": 0, "b": 0}

    def backend(name):
        async def handle(req):
            counts[name] += 1
            return Response(200, body=name.encode())
        return pkg["service"].FnService(handle)

    backs = [await serve(backend("a")), await serve(backend("b"))]
    disco = tmp_path / ("disco-" + ("ref" if pkg is REF else "port"))
    disco.mkdir()
    (disco / "web").write_text(f"127.0.0.1 {backs[0].bound_port}\n")
    (disco / "web-b").write_text(f"127.0.0.1 {backs[1].bound_port}\n")
    namerd = pkg["namerd"].Namerd(
        pkg["namerd"].InMemoryDtabStore(
            {"default": pkg["core"].Dtab.read(BASE_DTAB)}),
        namers=[(pkg["core"].Path.read("/io.l5d.fs"), FsNamer(str(disco)))])
    ctl_srv = await HttpServer(HttpControlService(namerd)).start()
    edge = load(e2e_config(ctl_srv.bound_port))
    tele = edge.telemeters[0]
    scorer = LevelScorer(0.0)
    tele._scorer = scorer
    await edge.start()
    drain = asyncio.ensure_future(tele.run())
    proxy = HttpClient("127.0.0.1", edge.routers[0].server_ports[0])
    flat = edge.metrics.flatten

    async def one():
        req = Request(uri="/")
        req.headers.set("Host", "web")
        rsp = await asyncio.wait_for(proxy(req), 5)
        assert rsp.status == 200
        return rsp.body

    try:
        for _ in range(5):
            await one()
        assert counts == {"a": 5, "b": 0}
        scorer.level = 0.9
        await eventually(lambda: flat().get(
            "control/reactor/overrides_published", 0) >= 1,
            "override publish", one)
        shifted = await ns_show(namerd.store)
        await eventually(lambda: counts["b"] > 0, "traffic shift", one)
        plateau = counts["a"]
        bodies = [await one() for _ in range(10)]
        assert counts["a"] == plateau and set(bodies) == {b"b"}
        scorer.level = 0.0
        await eventually(lambda: flat().get(
            "control/reactor/overrides_reverted", 0) >= 1,
            "override revert", one)
        await eventually(lambda: counts["a"] > plateau, "traffic return",
                         one)
        published = flat()["control/reactor/overrides_published"]
        for i in range(20):
            scorer.level = 0.9 if i % 2 == 0 else 0.0
            await one()
            await asyncio.sleep(0.03)
        scorer.level = 0.0
        status = tele.control.status()
        out = dict(
            shifted=shifted, final=await ns_show(namerd.store),
            published=flat()["control/reactor/overrides_published"],
            reverted=flat()["control/reactor/overrides_reverted"],
            rejected=flat().get("control/reactor/overrides_rejected", 0),
            oscillation_publishes=(
                flat()["control/reactor/overrides_published"] - published),
            active=status["reactor"]["active_overrides"],
            actuators=status["actuators"],
            # the effective limit follows the admission factor, which
            # moves with the timing of the control ticks
            limits=[lim["max"] for lim in status["admission"]["limits"]],
            steps=flat()["control/steps"])
        return out
    finally:
        drain.cancel()
        await asyncio.gather(drain, return_exceptions=True)
        await proxy.close()
        await edge.close()
        await ctl_srv.close()
        await namerd.close()
        for b in backs:
            await b.close()


def test_e2e_shift_and_revert_through_namerd(tmp_path):
    async def go():
        return await e2e(REF, tmp_path), await e2e(PORT, tmp_path)

    ref, port = run(go(), timeout=120)
    assert "/svc/web => /svc/web-b" in port["shifted"]
    assert port["final"] == ref_core.Dtab.read(BASE_DTAB).show
    for key in ("shifted", "final", "published", "reverted", "rejected",
                "oscillation_publishes", "active", "actuators", "limits"):
        assert port[key] == ref[key], key
    assert port["published"] == port["reverted"] == 1
    assert port["oscillation_publishes"] == 0
    assert port["steps"] > 0
