"""The serving layer's host modules in the port against the JAX
package's, on the CPU: the same scripted inputs through both classes
give EQUAL outputs.

* ``utils/timing.LatencyHistogram``, ``obs/registry`` (snapshot,
  Prometheus render, ``export_state``/``import_state``/``merge``),
  ``serve/metrics.ServeMetrics``;
* ``obs/health.HealthMonitor`` under a fake clock, ``obs/slo.SloTracker``
  burn rates, ``obs/reqtrace`` breakdowns and rid format,
  ``obs/disttrace`` wire round trips and clock offsets;
* ``serve/cache`` (``ResultCache`` LRU, ``normalize_query``),
  ``serve/supervisor`` (``RetryPolicy`` backoff, ``CircuitBreaker``,
  ``QuarantineList``, retry and poison bisection in
  ``SupervisedDispatch``);
* ``obs/devmon``, which is the port's own: on the CPU ``sample()``
  returns the empty per-device stats the JAX package's returns there,
  the watermark signal reads the same, ``census()`` attributes an
  owner's tensors by storage, and a native build reported after
  ``mark_warm()`` counts as one recompile.

Nothing here needs the native libraries, a GPU or wall-clock timing.
"""

import json
import random
import types

import numpy as np
import pytest
import torch

from tfidf_tpu import faults as jfaults
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.obs import devmon as jdevmon
from tfidf_tpu.obs import disttrace as jdist
from tfidf_tpu.obs import health as jhealth
from tfidf_tpu.obs import registry as jreg
from tfidf_tpu.obs import reqtrace as jreq
from tfidf_tpu.obs import slo as jslo
from tfidf_tpu.serve import cache as jcache
from tfidf_tpu.serve import metrics as jmetrics
from tfidf_tpu.serve import supervisor as jsup
from tfidf_tpu.utils.timing import LatencyHistogram as JHist

from tfidf_tpu_torch import faults as tfaults
from tfidf_tpu_torch import obs as tobs
from tfidf_tpu_torch.config import PipelineConfig as TConfig
from tfidf_tpu_torch.config import VocabMode as TVocab
from tfidf_tpu_torch.obs import devmon as tdevmon
from tfidf_tpu_torch.obs import disttrace as tdist
from tfidf_tpu_torch.obs import health as thealth
from tfidf_tpu_torch.obs import registry as treg
from tfidf_tpu_torch.obs import reqtrace as treq
from tfidf_tpu_torch.obs import slo as tslo
from tfidf_tpu_torch.serve import cache as tcache
from tfidf_tpu_torch.serve import metrics as tmetrics
from tfidf_tpu_torch.serve import supervisor as tsup
from tfidf_tpu_torch.utils.timing import LatencyHistogram as THist

SEEDS = [0, 1, 2, 3, 4, 5]


# --- LatencyHistogram -------------------------------------------------

def _samples(seed, n=200):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.lognormal(-5.0, 1.5, n)] + [0.0, 5e-7,
                                                               2e3]


@pytest.mark.parametrize("seed", SEEDS)
def test_latency_histogram_equal(seed):
    j, t = JHist(exemplars=True), THist(exemplars=True)
    for i, s in enumerate(_samples(seed)):
        j.record(s, exemplar=f"r{i}")
        t.record(s, exemplar=f"r{i}")
    assert t.as_dict() == j.as_dict()
    for p in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert t.percentile(p) == j.percentile(p)
    bounds = list(jreg.DEFAULT_BUCKETS)
    assert t.cumulative(bounds) == j.cumulative(bounds)
    assert t.state_dict() == j.state_dict()
    assert t.exemplars() == j.exemplars()
    # the wire form rebuilds across the packages
    assert THist.from_state(j.state_dict()).as_dict() == j.as_dict()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_latency_histogram_merge_equal(seed):
    a, b = _samples(seed), _samples(seed + 100)
    ja, jb, ta, tb = JHist(), JHist(), THist(), THist()
    for s in a:
        ja.record(s)
        ta.record(s)
    for s in b:
        jb.record(s)
        tb.record(s)
    assert ta.merge(tb).state_dict() == ja.merge(jb).state_dict()
    with pytest.raises(ValueError):
        THist(resolution=0.05).merge(THist())


# --- registry ------------------------------------------------------------

def _drive_registry(mod, seed):
    """One scripted sequence of instrument calls."""
    rng = random.Random(seed)
    reg = mod.MetricsRegistry()
    for step in range(60):
        op = rng.randrange(4)
        name = f"m{rng.randrange(5)}"
        if op == 0:
            reg.counter(f"c_{name}_total", "a counter").inc(
                rng.randrange(1, 4))
        elif op == 1:
            reg.gauge(f"g_{name}", "a gauge").set(rng.randrange(-5, 50))
        elif op == 2:
            reg.gauge(f"g_{name}", "a gauge").add(rng.randrange(-3, 4))
        else:
            reg.histogram(f"h_{name}_seconds", "a histogram").observe(
                rng.lognormvariate(-6, 1.2), exemplar=f"r{step}")
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_render_and_snapshot_equal(seed):
    j, t = _drive_registry(jreg, seed), _drive_registry(treg, seed)
    assert t.render_prom() == j.render_prom()
    assert t.snapshot() == j.snapshot()
    assert t.snapshot(reset_peaks=True) == j.snapshot(reset_peaks=True)
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_export_import_merge_equal(seed):
    j1, j2 = _drive_registry(jreg, seed), _drive_registry(jreg, seed + 7)
    t1, t2 = _drive_registry(treg, seed), _drive_registry(treg, seed + 7)
    assert t1.export_state() == j1.export_state()
    # the state crosses packages either way, and merges the same
    assert (treg.MetricsRegistry.import_state(j1.export_state())
            .render_prom() == j1.render_prom())
    assert (jreg.MetricsRegistry.import_state(t1.export_state())
            .render_prom() == t1.render_prom())
    assert t1.merge(t2).render_prom() == j1.merge(j2).render_prom()
    assert json.dumps(t1.export_state(), sort_keys=True) == json.dumps(
        j1.export_state(), sort_keys=True)


def test_registry_kind_clash_raises_in_both():
    for mod in (jreg, treg):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises((TypeError, ValueError)):
            reg.gauge("x_total")


def test_default_buckets_equal():
    assert tobs.DEFAULT_BUCKETS == jreg.DEFAULT_BUCKETS


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_serve_metrics_equal(seed):
    rng = random.Random(seed)
    j, t = jmetrics.ServeMetrics(), tmetrics.ServeMetrics()
    for step in range(80):
        op = rng.randrange(5)
        for m in (j, t):
            r = random.Random(seed * 1000 + step)
            if op == 0:
                m.observe_request(r.lognormvariate(-5, 1), r.randrange(1, 9),
                                  rid=f"r{step}")
            elif op == 1:
                q = r.randrange(1, 9)
                m.observe_batch(q, 1 << max(0, q - 1).bit_length())
            elif op == 2:
                m.set_queue_depth(r.randrange(0, 40))
            elif op == 3:
                m.count(r.choice(["cache_hits", "cache_misses",
                                  "shed_overload", "shed_deadline",
                                  "dispatch_retries", "poisoned",
                                  "slow_queries"]), r.randrange(1, 3))
            else:
                m.count("shed_overload")
    assert t.snapshot() == j.snapshot()
    assert t.render_prom() == j.render_prom()
    assert t.render() == j.render()


def test_batch_occupancy_divides_by_the_pow2_bucket():
    from tfidf_tpu.serve.batcher import _pow2 as jpow2
    from tfidf_tpu_torch.serve.batcher import _pow2 as tpow2
    assert [tpow2(n) for n in range(1, 600)] == [jpow2(n)
                                                 for n in range(1, 600)]
    t = tmetrics.ServeMetrics()
    t.observe_batch(3, tpow2(3))
    t.observe_batch(256, tpow2(256))
    assert t.snapshot()["batch"]["mean_occupancy"] == pytest.approx(
        (3 / 4 + 1.0) / 2)


# --- health under a fake clock ----------------------------------------

class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


def _health_script(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock.monotonic))
    snap = {"requests": 0, "shed": {"overload": 0, "deadline": 0},
            "queue": {"depth": 0}}
    busy = {"v": False}
    mon = mod.HealthMonitor(
        snapshot_fn=lambda: json.loads(json.dumps(snap)), queue_bound=8,
        thresholds=mod.HealthThresholds(stall_after_s=1.0))
    mon.register("batcher", busy_fn=lambda: busy["v"])
    mon.heartbeat("batcher")
    flag = {"reason": None}
    mon.add_signal("memory_pressure", lambda: (0.5, flag["reason"]))
    out = []

    def ev():
        st = mon.evaluate(now=clock.t)
        out.append((st.as_dict(), mon.admission_bound(8)))

    ev()                                   # ok
    snap["queue"]["depth"] = 8
    clock.t += 0.25
    ev()                                   # saturation -> degraded
    snap["queue"]["depth"] = 0
    snap["requests"] = 10
    snap["shed"]["overload"] = 10
    clock.t += 0.25
    ev()                                   # shed rate -> degraded
    snap["requests"] = 40
    clock.t += 0.25
    ev()
    busy["v"] = True
    clock.t += 2.0
    ev()                                   # stalled -> unhealthy
    mon.heartbeat("batcher")
    flag["reason"] = "memory pressure 0.90 >= watermark 0.80"
    clock.t += 0.25
    ev()                                   # signal -> degraded
    flag["reason"] = None
    busy["v"] = False
    snap["requests"] = 100
    clock.t += 0.25
    ev()
    clock.t += 0.25
    ev()                                   # recovered
    return out


def test_health_states_equal_under_fake_clock(monkeypatch):
    j = _health_script(jhealth, monkeypatch)
    t = _health_script(thealth, monkeypatch)
    assert t == j
    states = [s["status"] for s, _ in t]
    assert states[0] == "ok" and "unhealthy" in states
    assert "degraded" in states and states[-1] == "ok"
    assert min(b for _, b in t) < 8 == t[0][1]


def test_health_module_hook():
    mon = thealth.HealthMonitor()
    thealth.set_monitor(mon)
    try:
        thealth.beat("packer")
        assert thealth.get_monitor() is mon
    finally:
        thealth.set_monitor(None)
    assert "packer" in mon.evaluate().checks["workers"]


# --- SLO burn ----------------------------------------------------------

def _slo_script(mod, seed):
    clock = _Clock(5000.0)
    reg = (jreg if mod is jslo else treg).MetricsRegistry()
    tr = mod.SloTracker(objective_ms=20.0, target=0.9, fast_window_s=10.0,
                        slow_window_s=60.0, min_count=5, registry=reg,
                        clock=clock.monotonic)
    rng = random.Random(seed)
    out = []
    for step in range(120):
        clock.t += rng.choice([0.0, 0.3, 1.0, 2.5])
        bad_phase = 40 <= step < 70
        lat = (rng.uniform(0.025, 0.1) if bad_phase and rng.random() < 0.7
               else rng.uniform(0.001, 0.019))
        out.append(tr.record(lat))
        if step % 10 == 9:
            out.append((tr.snapshot(), tr.health_signal()))
    out.append(reg.render_prom())
    return out


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_slo_burn_equal(seed):
    j, t = _slo_script(jslo, seed), _slo_script(tslo, seed)
    assert t == j
    assert any(sig[1] is not None for snap, sig in
               (x for x in t if isinstance(x, tuple)))


# --- reqtrace --------------------------------------------------------------

def test_reqtrace_breakdown_and_rid_format_equal():
    assert treq.PHASES == jreq.PHASES
    j = jreq.RequestContext("r1-1", 3, 5, trace="t" + "a" * 16)
    t = treq.RequestContext("r1-1", 3, 5, trace="t" + "a" * 16)
    for ctx in (j, t):
        ctx.mark("cache", 0.001)
        ctx.mark("queue_wait", 0.0025)
        ctx.mark("device", 0.004)
        ctx.mark("device", 0.001)          # a bisected re-dispatch adds
        ctx.note("dispatch_retry", n=2)
    assert t.breakdown() == j.breakdown()
    assert t.anomalies == j.anomalies
    rid = treq.next_rid()
    assert rid.startswith("r") and "-" in rid
    assert len(rid.split("-")[0]) == len(jreq.next_rid().split("-")[0])


def test_reqtrace_off_switch():
    assert treq.configure(False) is False
    try:
        assert treq.start(2, 3) is None
    finally:
        treq.configure(None)          # back to the env default: on
    assert treq.start(2, 3) is not None


def test_reqtrace_slow_query_event(monkeypatch):
    from tfidf_tpu_torch.obs import log as tlog
    log = tlog.EventLog()
    monkeypatch.setattr(tlog, "_log", log)
    ctx = treq.start(2, 4)
    ctx.batch, ctx.co_occupants, ctx.epoch = 7, 3, 1
    assert treq.finish(ctx, "drained", slow_ms=0.0) == "slow"
    ev = [e for e in log.events() if e["event"] == "slow_query"]
    assert ev and ev[-1]["rid"] == ctx.rid and ev[-1]["batch"] == 7
    assert set(ev[-1]["breakdown"]) == set(treq.PHASES)


# --- disttrace -----------------------------------------------------------

WIRE_CASES = [
    None, {}, "t0123456789abcdef", {"id": "t0123456789abcdef"},
    {"id": "t0123456789abcdef", "parent": "s01"},
    {"id": "t0123456789ABCDEF", "parent": "s01"},
    {"id": "x0123456789abcdef", "parent": "s01"},
    {"id": "t0123", "parent": "s01"}, {"id": 7, "parent": "s"},
    {"id": "t0123456789abcdef", "parent": 5}, [1, 2], 42,
    {"id": "t0123456789abcdef", "parent": "s" * 200},
    {"trace": "t0123456789abcdef", "parent": "s01"},
]


@pytest.mark.parametrize("case", range(len(WIRE_CASES)))
def test_disttrace_from_wire_equal(case):
    wire = WIRE_CASES[case]
    j, t = jdist.from_wire(wire), tdist.from_wire(wire)
    assert (t is None) == (j is None)
    if case in (3, 4):
        assert t is not None
    if t is not None:
        assert (t.trace, t.parent) == (j.trace, j.parent)
        assert tdist.to_wire(t) == jdist.to_wire(j)
        back = jdist.from_wire(tdist.to_wire(t))
        assert (back.trace, back.parent) == (t.trace, t.parent)


def test_disttrace_ids_and_clock_offset_equal():
    for s in ("t0123456789abcdef", "t0123", "r1-1", None, 5):
        assert tdist.is_trace_id(s) == jdist.is_trace_id(s)
    ctx = tdist.mint()
    assert ctx is None or jdist.is_trace_id(ctx.trace)
    je, te = jdist.ClockOffsetEstimator(), tdist.ClockOffsetEstimator()
    rng = random.Random(3)
    for _ in range(20):
        send = rng.randrange(10 ** 9)
        rtt = rng.randrange(10 ** 3, 10 ** 6)
        peer = send + rtt // 2 + 12345
        for est in (je, te):
            est.add_sample(send, peer, send + rtt)
    assert te.as_meta() == je.as_meta()


# --- cache -----------------------------------------------------------------

QUERY_CASES = ["apple cherry", "  apple\t cherry \n", "", "   ",
               "APPLE apple", "café naïve", b"raw bytes here",
               "apples appleXYZ", "a b c d e f g h i j"]


@pytest.mark.parametrize("trunc", [None, 4])
def test_normalize_query_equal(trunc):
    jc = JConfig(vocab_mode=JVocab.HASHED, truncate_tokens_at=trunc)
    tc = TConfig(vocab_mode=TVocab.HASHED, truncate_tokens_at=trunc)
    for q in QUERY_CASES:
        assert tcache.normalize_query(q, tc) == jcache.normalize_query(q, jc)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_result_cache_lru_equal(seed):
    rng = random.Random(seed)
    j, t = jcache.ResultCache(entries=5), tcache.ResultCache(entries=5)
    seen = []
    for step in range(200):
        toks = (f"w{rng.randrange(12)}".encode(),)
        k, epoch = rng.choice([3, 5]), rng.randrange(2)
        skey, fkey = rng.choice(["tfidf", "bm25:b=0.75,k1=1.2"]), ""
        if rng.random() < 0.5:
            row = (np.full(k, step, np.float32), np.arange(k))
            j.put(j.key(toks, k, epoch, skey, fkey), *row)
            t.put(t.key(toks, k, epoch, skey, fkey), *row)
        else:
            a = j.get(j.key(toks, k, epoch, skey, fkey))
            b = t.get(t.key(toks, k, epoch, skey, fkey))
            seen.append((None if a is None else a[0].tolist(),
                         None if b is None else b[0].tolist()))
    assert all(a == b for a, b in seen)
    assert (t.hits, t.misses, len(t)) == (j.hits, j.misses, len(j))
    t.clear()
    assert len(t) == 0


# --- supervisor --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 9])
def test_retry_backoff_equal(seed):
    jrng, trng = random.Random(seed), random.Random(seed)
    for attempt in range(1, 9):
        assert (tfaults.backoff_s(attempt, 10.0, 2.0, 1000.0, 0.5, trng)
                == jfaults.backoff_s(attempt, 10.0, 2.0, 1000.0, 0.5, jrng))
    assert tsup.RetryPolicy() == tsup.RetryPolicy(
        **{f: getattr(jsup.RetryPolicy(), f)
           for f in ("max_attempts", "backoff_ms", "backoff_mult",
                     "max_backoff_ms", "jitter", "seed")})


def _breaker_script(mod, regmod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, sleep=lambda s: None))
    reg = regmod.MetricsRegistry()
    br = mod.CircuitBreaker(threshold=3, cooldown_s=1.0, registry=reg)
    out = []
    for op in "ffsfffxffxsfffx":
        if op == "f":
            out.append(br.record_failure())
        elif op == "s":
            br.record_success()
        else:
            clock.t += 1.5
        out.append((br.state, br.consecutive_failures,
                    br.cooldown_remaining(), br.health_signal()))
    out.append(reg.render_prom())
    return out


def test_circuit_breaker_equal(monkeypatch):
    j = _breaker_script(jsup, jreg, monkeypatch)
    t = _breaker_script(tsup, treg, monkeypatch)
    assert t == j
    assert any(isinstance(x, tuple) and x[0] == "half_open" for x in t)


def test_quarantine_equal():
    jq = jsup.QuarantineList(cap=3, registry=jreg.MetricsRegistry())
    tq = tsup.QuarantineList(cap=3, registry=treg.MetricsRegistry())
    for key in [(b"a",), (b"b",), (b"a",), (b"c",), (b"d",), (b"e",)]:
        assert tq.add(key, query_repr=str(key)) == jq.add(
            key, query_repr=str(key))
        assert len(tq) == len(jq) and tq.snapshot() == jq.snapshot()
    for key in [(b"a",), (b"e",), (b"z",)]:
        assert tq.contains(key) == jq.contains(key)


def _fake_search(faultmod, poison=(), transient=0):
    """A search over query strings: row i scores len(q) at id hash(q);
    a poison query raises a FatalFault; the first ``transient`` calls
    raise a TransientFault."""
    calls = {"n": 0}

    def fn(queries, k, group):
        calls["n"] += 1
        if calls["n"] <= transient:
            raise faultmod.TransientFault("flaky", seam="device_dispatch")
        if any(q in poison for q in queries):
            raise faultmod.FatalFault("boom", seam="device_dispatch")
        vals = np.array([[float(len(q))] * k for q in queries], np.float32)
        ids = np.array([[sum(map(ord, q)) % 97] * k for q in queries],
                       np.int32)
        return vals, ids
    return fn, calls


SUP_CASES = [
    ([f"q{i}" for i in range(8)], (), 0),
    ([f"q{i}" for i in range(8)], (), 2),
    ([f"q{i}" for i in range(8)], ("q3",), 0),
    ([f"q{i}" for i in range(8)], ("q0", "q5", "q6"), 0),
    ([f"q{i}" for i in range(5)], ("q4",), 1),
    ([f"q{i}" for i in range(1)], ("q0",), 0),
    ([f"q{i}" for i in range(6)], tuple(f"q{i}" for i in range(6)), 0),
]


@pytest.mark.parametrize("case", range(len(SUP_CASES)))
def test_supervised_dispatch_equal(case):
    queries, poison, transient = SUP_CASES[case]
    outs = []
    for sup, fmod, mmod in ((jsup, jfaults, jmetrics),
                            (tsup, tfaults, tmetrics)):
        fn, calls = _fake_search(fmod, poison, transient)
        metrics = mmod.ServeMetrics()
        disp = sup.SupervisedDispatch(
            fn, sup.RetryPolicy(max_attempts=3, backoff_ms=0.0),
            breaker=sup.CircuitBreaker(threshold=50), metrics=metrics)
        vals, ids, bad = disp.run_batch(queries, 2, None, batch_id=1)
        outs.append((None if vals is None else vals.tolist(),
                     None if ids is None else ids.tolist(), bad,
                     calls["n"], metrics.snapshot()))
    assert outs[1] == outs[0]
    assert outs[1][2] == sorted(queries.index(p) for p in poison)


def test_supervised_transient_past_budget_raises_in_both():
    for sup, fmod in ((jsup, jfaults), (tsup, tfaults)):
        fn, _ = _fake_search(fmod, transient=10)
        disp = sup.SupervisedDispatch(
            fn, sup.RetryPolicy(max_attempts=2, backoff_ms=0.0))
        with pytest.raises(fmod.TransientFault):
            disp.run_batch(["a", "b"], 1, None)


# --- devmon: the port's own ------------------------------------------------

def test_devmon_cpu_sample_is_the_empty_stats():
    jsnap = jdevmon.DeviceMonitor().sample()
    for device in ("cpu", None) if not torch.cuda.is_available() else ("cpu",):
        reg = treg.MetricsRegistry()
        mon = tdevmon.DeviceMonitor(registry=reg, device=device)
        snap = mon.sample()
        assert snap["devices"] == [{"device": 0, "kind": "cpu",
                                    "platform": "cpu"}]
        # the JAX package's CPU entries carry the same keys, no stats
        assert all(set(d) == {"device", "kind", "platform"}
                   and d["platform"] == "cpu" for d in jsnap["devices"])
        for key in ("memory_pressure", "peak_bytes", "samples"):
            assert snap[key] == jsnap[key]
        assert reg.snapshot() == {} or not any(
            name.startswith("hbm_") for name in reg.snapshot())
        assert mon.health_signal() == (0.0, None)


@pytest.mark.parametrize("in_use", [100, 850, 960, 400])
def test_devmon_watermark_signal_equal(in_use):
    stats = {"bytes_in_use": in_use, "peak_bytes_in_use": 990,
             "bytes_limit": 1000}
    j = jdevmon.DeviceMonitor(watermarks=(0.8, 0.95),
                              stats_fn=lambda dev: dict(stats))
    t = tdevmon.DeviceMonitor(watermarks=(0.8, 0.95),
                              stats_fn=lambda i: dict(stats))
    js, ts = j.sample(), t.sample()
    assert ts["memory_pressure"] == js["memory_pressure"]
    assert t.health_signal() == j.health_signal()
    rec = {k: v for k, v in ts["devices"][0].items()
           if k not in ("kind", "platform")}
    want = {k: v for k, v in js["devices"][0].items()
            if k not in ("kind", "platform")}
    assert rec == want


def test_devmon_gauges_and_watermark_events(monkeypatch):
    from tfidf_tpu_torch.obs import log as tlog
    log = tlog.EventLog()
    monkeypatch.setattr(tlog, "_log", log)
    level = {"v": 900}
    reg = treg.MetricsRegistry()
    mon = tdevmon.DeviceMonitor(
        registry=reg, watermarks=(0.8, 0.95),
        stats_fn=lambda i: {"bytes_in_use": level["v"],
                            "peak_bytes_in_use": 990, "bytes_limit": 1000})
    mon.sample()
    snap = reg.snapshot()
    assert snap["hbm_bytes_in_use_d0"]["value"] == 900
    assert snap["hbm_bytes_limit_d0"]["value"] == 1000
    assert snap["hbm_peak_bytes_d0"]["value"] == 990
    level["v"] = 100
    snap = mon.sample()
    kinds = [e["event"] for e in log.events()]
    assert kinds.count("hbm_watermark") == 1
    assert kinds.count("hbm_watermark_clear") == 1
    assert snap["peak_bytes"] == 990 and snap["samples"] == 2


def test_devmon_census_by_storage():
    a = torch.zeros(100, dtype=torch.float32)
    b = torch.zeros((4, 8), dtype=torch.int32)
    view = a[10:20]                       # shares a's storage
    mon = tdevmon.DeviceMonitor(device="cpu")
    mon.register_owner("resident_index", lambda: [a, b, view, None])
    mon.register_owner("broken", lambda: 1 / 0)
    c = mon.census()
    want = a.untyped_storage().nbytes() + b.untyped_storage().nbytes()
    assert c["owners"]["resident_index"] == {"bytes": want, "arrays": 3}
    assert "broken" not in c["owners"]
    assert c["owners"]["other"]["bytes"] == 0
    assert c["total_bytes"] == want and c["buffers"] == 2
    assert c["top_shapes"][0] == {"dtype": "float32", "shape": [100],
                                  "bytes": 400}
    # re-registering a name replaces its callable (a hot swap)
    mon.register_owner("resident_index", lambda: [b])
    assert mon.census()["owners"]["resident_index"]["bytes"] == \
        b.untyped_storage().nbytes()


def test_build_report_after_warm_is_one_recompile(tmp_path, monkeypatch):
    from pathlib import Path

    from tfidf_tpu_torch.obs import log as tlog
    from tfidf_tpu_torch.ops import _build
    log = tlog.EventLog(echo="off")
    monkeypatch.setattr(tlog, "_log", log)
    reg = treg.MetricsRegistry()
    watch = tdevmon.CompileWatch(registry=reg)
    tdevmon.set_watch(watch)
    try:
        _build._report("host", 4.5, Path(tmp_path) / "libx.so")
        assert (watch.compiles, watch.recompile_count) == (1, 0)
        assert watch.health_signal() == (0, None)
        watch.mark_warm()
        _build._report("kernels", 61.25, Path(tmp_path) / "liby.so")
        assert (watch.compiles, watch.recompile_count) == (2, 1)
        n, reason = watch.health_signal()
        assert n == 1 and "after warm-up" in reason
        snap = reg.snapshot()
        assert snap["xla_compiles_total"] == 2
        assert snap["xla_compile_seconds_total"] == pytest.approx(65.75)
        assert snap["xla_recompiles_after_warm"] == 1
        recompiles = [e for e in log.events()
                      if e["event"] == "xla_recompile"]
        assert len(recompiles) == 1
        assert recompiles[0]["program"] == "kernels"
        assert recompiles[0]["library"] == "liby.so"
    finally:
        tdevmon.set_watch(None)
    # with no watch installed a report is a no-op
    _build._report("kernels", 1.0, Path(tmp_path) / "libz.so")


def test_compile_watch_names_match_the_jax_package():
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    jdevmon.CompileWatch(registry=jr)
    tdevmon.CompileWatch(registry=tr)
    assert sorted(tr.snapshot()) == sorted(jr.snapshot())


def test_obs_lazy_members_are_the_modules_classes():
    assert tobs.MetricsRegistry is treg.MetricsRegistry
    assert tobs.HealthMonitor is thealth.HealthMonitor
    assert tobs.DeviceMonitor is tdevmon.DeviceMonitor
    assert tobs.CompileWatch is tdevmon.CompileWatch
    assert tobs.SloTracker is tslo.SloTracker
    with pytest.raises(AttributeError):
        tobs.NoSuchMember
