"""The port's metrics registry, exposition and server, and the engine's
instruments, against the JAX package.

- The registry, exposition and server cases of the JAX package's metrics
  tests run once per package: both ``metrics`` packages are jax-free and
  must behave the same. Histogram quantiles are held to the enclosing
  bucket's width, as there.
- The same traffic (prefix hits, drafts, a rejected, an expired and a
  cancelled request, a NaN quarantine) through the JAX and the port
  engine, on the same weights, each engine labelled with one engine id:
  the two registries hold the same serving series (names and label
  sets), equal counter and gauge values and equal histogram counts (and
  equal sums where a histogram counts tokens, not seconds);
  ``compile_counts()["step"] == ["step_buckets"]`` equals the
  ``paddle_tpu_jit_compiles_total{fn="serving_step"}`` the run added.
- The JAX package's overhead guards compare wall-clock times of a loaded
  host and have no twin here.
"""
import importlib
import json
import math
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import faults as torch_faults
from paddle_tpu_torch import metrics as torch_metrics
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.serving import ServingEngine

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|$)')


def _unescape(v: str) -> str:
    return (v.replace(r"\n", "\n").replace(r"\"", '"')
            .replace("\\\\", "\\"))


def parse_prometheus(text):
    """A strict text-format 0.0.4 reader: {name: {"type", "help",
    "samples"}}, samples as (sample_name, labels, value). Raises on any
    malformed line."""
    out = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            out.setdefault(name, {"type": "untyped", "help": "",
                                  "samples": []})["help"] = \
                _unescape(help_text)
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            assert kind.strip() in ("counter", "gauge", "histogram",
                                    "summary", "untyped"), line
            out.setdefault(name, {"type": "untyped", "help": "",
                                  "samples": []})["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"line {lineno} is not a valid sample: {line!r}"
        sname, body, value = m.groups()
        labels = {}
        if body:
            pairs = list(_LABEL_PAIR_RE.finditer(body))
            assert sum(len(p.group(0)) for p in pairs) == len(body), body
            labels = {p.group(1): _unescape(p.group(2)) for p in pairs}
        fam = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[:-len(suffix)] in out:
                fam = sname[:-len(suffix)]
        out.setdefault(fam, {"type": "untyped", "help": "", "samples": []})
        v = float("inf") if value == "+Inf" else float(value)
        out[fam]["samples"].append((sname, labels, v))
    return out


@pytest.fixture(params=PACKAGES)
def M(request):
    return importlib.import_module(f"{request.param}.metrics")


class TestInstruments:
    def test_counter_inc_and_monotonic(self, M):
        c = M.MetricsRegistry().counter("paddle_tpu_test_total", "help me")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_gauge_set_inc_dec(self, M):
        g = M.MetricsRegistry().gauge("paddle_tpu_test_depth", "")
        g.set(7)
        g.inc()
        g.dec(3)
        assert g.value == 5.0

    def test_registry_get_or_create_idempotent_and_type_checked(self, M):
        reg = M.MetricsRegistry()
        c1 = reg.counter("paddle_tpu_x_total")
        assert reg.counter("paddle_tpu_x_total") is c1
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("paddle_tpu_x_total")
        with pytest.raises(ValueError, match="labels"):
            reg.counter("paddle_tpu_x_total", labels=("route",))
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name!")

    def test_label_set_identity(self, M):
        c = M.MetricsRegistry().counter("paddle_tpu_req_total",
                                        labels=("method", "code"))
        a = c.labels(method="GET", code="200")
        assert c.labels(code="200", method="GET") is a
        assert c.labels("GET", "200") is a
        other = c.labels(method="GET", code="500")
        assert other is not a
        a.inc(3)
        other.inc()
        assert a.value == 3 and other.value == 1
        with pytest.raises(ValueError):
            c.labels(method="GET")
        with pytest.raises(ValueError):
            c.labels("GET")

    def test_unlabeled_family_rejects_labels_and_vice_versa(self, M):
        reg = M.MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("paddle_tpu_plain_total").labels(x="1")
        with pytest.raises(ValueError, match="declares labels"):
            reg.counter("paddle_tpu_lab_total", labels=("x",)).inc()


class TestHistogram:
    def test_bucket_index_exponential_matches_linear_scan(self, M):
        h = M.MetricsRegistry().histogram("paddle_tpu_h_seconds")
        bounds = h.buckets
        rng = np.random.default_rng(0)
        vals = ([0.0, bounds[0], bounds[-1], bounds[-1] * 10] + list(bounds)
                + [b * (1 + 1e-12) for b in bounds]
                + list(rng.uniform(0, bounds[-1] * 1.1, 200)))
        for v in vals:
            want = next((i for i, b in enumerate(bounds) if v <= b),
                        len(bounds))
            assert h._bucket_index(float(v)) == want, v

    def test_custom_buckets_and_inf_terminal(self, M):
        reg = M.MetricsRegistry()
        h = reg.histogram("paddle_tpu_c_seconds", buckets=[1, 2, 4, math.inf])
        assert h.buckets == [1.0, 2.0, 4.0]
        for v in (0.5, 2.0, 3.0, 100.0):
            h.observe(v)
        series = reg.snapshot()["paddle_tpu_c_seconds"]["series"][0]
        assert [c for _, c in series["buckets"]] == [1, 2, 3, 4]
        assert series["count"] == 4 and series["sum"] == 105.5

    def test_bad_buckets_rejected(self, M):
        reg = M.MetricsRegistry()
        with pytest.raises(ValueError):
            reg.histogram("paddle_tpu_b1_seconds", buckets=[])
        with pytest.raises(ValueError):
            reg.histogram("paddle_tpu_b2_seconds", buckets=[2, 1])
        with pytest.raises(ValueError, match="finite"):
            reg.histogram("paddle_tpu_b3_seconds", buckets=[math.inf])
        with pytest.raises(ValueError):
            M.exponential_buckets(0, 2, 5)

    def test_standalone_instruments_usable(self, M):
        c = M.Counter("paddle_tpu_standalone_total")
        c.inc(2)
        assert c.value == 2
        M.Gauge("paddle_tpu_standalone_depth").set(1)
        h = M.Histogram("paddle_tpu_standalone_seconds")
        h.observe(0.5)
        assert h.count == 1
        assert M.get_registry().get("paddle_tpu_standalone_total") is None

    def test_quantiles_against_numpy(self, M):
        samples = np.random.default_rng(7).lognormal(-4.0, 1.0, 5000)
        h = M.MetricsRegistry().histogram("paddle_tpu_q_seconds")
        for v in samples:
            h.observe(v)
        bounds = [0.0] + h.buckets
        for q in (0.5, 0.9, 0.95, 0.99):
            want = float(np.quantile(samples, q))
            i = next(i for i in range(1, len(bounds)) if want <= bounds[i])
            assert abs(h.quantile(q) - want) <= bounds[i] - bounds[i - 1]

    def test_quantile_empty_and_bad_q(self, M):
        h = M.MetricsRegistry().histogram("paddle_tpu_e_seconds")
        assert h.quantile(0.5) is None
        with pytest.raises(ValueError):
            h.quantile(1.5)

    def test_time_histogram_context_manager(self, M):
        h = M.MetricsRegistry().histogram("paddle_tpu_t_seconds")
        with M.time_histogram(h):
            pass
        with h.time():
            pass
        assert h.count == 2 and h.sum >= 0

    def test_disabled_registry_records_nothing(self, M):
        reg = M.MetricsRegistry()
        c = reg.counter("paddle_tpu_d_total")
        h = reg.histogram("paddle_tpu_d_seconds")
        reg.disable()
        c.inc()
        h.observe(1.0)
        with h.time():
            pass
        assert c.value == 0 and h.count == 0
        reg.enable()
        c.inc()
        assert c.value == 1


class TestThreadSafety:
    def test_concurrent_inc_is_exact(self, M):
        reg = M.MetricsRegistry()
        c = reg.counter("paddle_tpu_mt_total")
        h = reg.histogram("paddle_tpu_mt_seconds")

        def work():
            for _ in range(2000):
                c.inc()
                h.observe(0.001)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value == 16000 and h.count == 16000

    def test_concurrent_label_creation_single_child(self, M):
        c = M.MetricsRegistry().counter("paddle_tpu_mtl_total", labels=("k",))
        out = []
        barrier = threading.Barrier(8)

        def work():
            barrier.wait()
            out.append(c.labels(k="x"))

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(ch is out[0] for ch in out)


def _expo_registry(M):
    reg = M.MetricsRegistry()
    reg.counter("paddle_tpu_req_total", "requests served",
                labels=("route",)).labels(route="/v1/completions").inc(5)
    reg.gauge("paddle_tpu_depth", "queue depth\nwith newline").set(3)
    h = reg.histogram("paddle_tpu_lat_seconds", "latency", buckets=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


class TestExposition:
    def test_prometheus_parses_and_round_trips(self, M):
        fams = parse_prometheus(_expo_registry(M).expose_prometheus())
        assert fams["paddle_tpu_req_total"]["type"] == "counter"
        assert fams["paddle_tpu_req_total"]["help"] == "requests served"
        (_s, labels, v), = fams["paddle_tpu_req_total"]["samples"]
        assert labels == {"route": "/v1/completions"} and v == 5
        assert fams["paddle_tpu_depth"]["help"] == "queue depth\nwith newline"
        hs = fams["paddle_tpu_lat_seconds"]["samples"]
        assert [(lab["le"], v) for n, lab, v in hs if n.endswith("_bucket")] \
            == [("0.1", 1), ("1", 2), ("+Inf", 3)]
        assert ("paddle_tpu_lat_seconds_count", {}, 3.0) in hs
        [sum_v] = [v for n, _, v in hs if n.endswith("_sum")]
        assert sum_v == pytest.approx(5.55, rel=1e-12)

    def test_label_value_escaping(self, M):
        reg = M.MetricsRegistry()
        nasty = 'a"b\\c\nd'
        reg.counter("paddle_tpu_esc_total", labels=("path",)).labels(
            path=nasty).inc()
        fams = parse_prometheus(reg.expose_prometheus())
        (_, labels, v), = fams["paddle_tpu_esc_total"]["samples"]
        assert labels == {"path": nasty} and v == 1

    def test_snapshot_shape_and_json_round_trip(self, M):
        snap = json.loads(json.dumps(_expo_registry(M).snapshot()))
        assert snap["paddle_tpu_req_total"]["type"] == "counter"
        hist = snap["paddle_tpu_lat_seconds"]["series"][0]
        assert hist["count"] == 3 and hist["p50"] is not None
        assert [b for b, _ in hist["buckets"]] == [0.1, 1.0, "+Inf"]
        assert [c for _, c in hist["buckets"]] == [1, 2, 3]

    def test_sanitize_metric_name(self, M):
        assert (M.sanitize_metric_name("serving.queue_depth")
                == "paddle_tpu_serving_queue_depth")
        assert M.sanitize_metric_name("paddle_tpu_x") == "paddle_tpu_x"
        assert M.sanitize_metric_name("9bad").startswith("paddle_tpu_")

    def test_reset_zeroes_but_keeps_families(self, M):
        reg = _expo_registry(M)
        reg.reset()
        snap = reg.snapshot()
        assert snap["paddle_tpu_req_total"]["series"][0]["value"] == 0
        assert snap["paddle_tpu_lat_seconds"]["series"][0]["count"] == 0


class TestMetricsServer:
    def test_scrape_healthz_and_json(self, M):
        reg = M.MetricsRegistry()
        reg.counter("paddle_tpu_up_total", "liveness").inc()
        with M.MetricsServer(registry=reg, port=0) as srv:
            assert srv.port != 0
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=10) as r:
                assert r.status == 200
                assert r.headers["Content-Type"].startswith("text/plain")
                fams = parse_prometheus(r.read().decode())
            assert fams["paddle_tpu_up_total"]["samples"][0][2] == 1
            with urllib.request.urlopen(srv.url + "/healthz",
                                        timeout=10) as r:
                assert r.read() == b"ok\n"
            with urllib.request.urlopen(srv.url + "/metrics.json",
                                        timeout=10) as r:
                snap = json.loads(r.read())
            assert snap["paddle_tpu_up_total"]["series"][0]["value"] == 1
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(srv.url + "/nope", timeout=10)

    def test_healthz_follows_health_cb(self, M):
        state = {"status": "ok"}
        with M.MetricsServer(registry=M.MetricsRegistry(), port=0,
                             health_cb=lambda: dict(state)) as srv:
            with urllib.request.urlopen(srv.url + "/healthz",
                                        timeout=10) as r:
                assert r.status == 200
            state["status"] = "degraded"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(srv.url + "/healthz", timeout=10)
            assert ei.value.code == 503
            assert json.loads(ei.value.read())["status"] == "degraded"

    def test_stop_idempotent(self, M):
        srv = M.MetricsServer(registry=M.MetricsRegistry()).start()
        srv.stop()
        srv.stop()


# ──────────────────────── the engines' instruments ────────────────────────

WIDTHS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
# histograms of token counts (not seconds): their sums compare too
TOKEN_HISTOGRAMS = ("paddle_tpu_serving_step_mix",
                    "paddle_tpu_serving_prefill_chunk_tokens",
                    "paddle_tpu_serving_spec_acceptance_ratio")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDTHS))
    tm = LlamaForCausalLM(llama_tiny(**WIDTHS), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


class _EchoDrafter:
    def propose(self, ids, k):
        return np.asarray(ids[-k:], np.int32)


def _traffic(engine, faults):
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 128, (8,))
    rids = [engine.add_request(np.concatenate([shared, [1, 2]]),
                               max_new_tokens=5)]
    engine.run()
    rids.append(engine.add_request(np.concatenate([shared, [3]]),
                                   max_new_tokens=4, temperature=0.8))
    rids.append(engine.add_request(rng.randint(0, 128, (6,)),
                                   max_new_tokens=6))
    rids.append(engine.add_request(rng.randint(0, 128, (3,)),
                                   max_new_tokens=3, deadline_s=0.0))
    with pytest.raises(ValueError):
        engine.add_request(rng.randint(0, 128, (70,)), max_new_tokens=2)
    engine.step()
    engine.step()
    engine.cancel(rids[2])
    victim = engine.add_request(rng.randint(0, 128, (5,)), max_new_tokens=8)
    rids.append(victim)
    engine.step()
    with faults.inject("serving.decode_step",
                       call=lambda: engine.pool.poison_seq(victim), times=1):
        outs = engine.run()
    return rids, outs


# the engine's unlabelled serving families: deltas of the run, and the
# gauges its last step set (tokens/s is a wall-clock rate: name only)
DELTAS = ("paddle_tpu_serving_queue_wait_seconds",
          "paddle_tpu_serving_queue_rejections_total",
          "paddle_tpu_jit_compiles_total")
LAST = ("paddle_tpu_serving_queue_depth", "paddle_tpu_serving_running_seqs",
        "paddle_tpu_serving_page_utilization",
        "paddle_tpu_serving_tokens_per_sec")


def _series(metrics_mod, engine_id, before):
    """{(name, labels): value} of one registry: every serving series
    labelled with ``engine_id`` (histograms as their count, and their sum
    where they count tokens), the step compiles and the unlabelled
    families as deltas against ``before``, and the last step's gauges."""
    out = {}
    for name, fam in metrics_mod.get_registry().snapshot().items():
        for s in fam["series"]:
            lab = s["labels"]
            key = (name, tuple(sorted(lab.items())))
            hist = fam["type"] == "histogram"
            val = ((s["count"], s["sum"] if name in TOKEN_HISTOGRAMS
                    else None) if hist else s["value"])
            if name in DELTAS:
                if lab.get("fn", "serving_step") != "serving_step":
                    continue
                b = before.get(key, (0, 0.0) if hist else 0.0)
                val = (val[0] - b[0], None) if hist else val - b
            elif name in LAST:
                val = None if name.endswith("tokens_per_sec") else val
            elif not (name.startswith("paddle_tpu_serving_")
                      and lab.get("engine_id") == engine_id):
                continue
            out[key] = val
    return out


def _raw(metrics_mod):
    out = {}
    for name, fam in metrics_mod.get_registry().snapshot().items():
        for s in fam["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = ((s["count"], s["sum"]) if fam["type"] == "histogram"
                        else s["value"])
    return out


def test_engine_series_match_jax(models):
    import paddle_tpu.faults as jax_faults
    import paddle_tpu.metrics as jax_metrics

    jm, tm = models
    eid = "metrics-parity"
    jax_before, torch_before = _raw(jax_metrics), _raw(torch_metrics)
    jeng = JaxEngine(jm, page_size=4, max_batch_slots=2, spec_k=2,
                     drafter=_EchoDrafter(), engine_id=eid, model_id="m")
    teng = ServingEngine(tm, page_size=4, max_batch_slots=2, spec_k=2,
                         drafter=_EchoDrafter(), engine_id=eid, model_id="m",
                         device="cpu")
    jrids, jouts = _traffic(jeng, jax_faults)
    trids, touts = _traffic(teng, torch_faults)
    assert [(touts[r].finish_reason, touts[r].token_ids) for r in trids
            if r in touts] == [(jouts[r].finish_reason, jouts[r].token_ids)
                               for r in jrids if r in jouts]
    want = _series(jax_metrics, eid, jax_before)
    got = _series(torch_metrics, eid, torch_before)
    assert sorted(got) == sorted(want)
    assert got == want
    lbl = (("engine_id", eid), ("model_id", "m"))
    # the run's telemetry, read from the port's series
    assert got[("paddle_tpu_serving_ttft_seconds", lbl)][0] == 4
    assert got[("paddle_tpu_serving_nan_quarantines_total", lbl)] == 1
    assert got[("paddle_tpu_serving_expired_total", lbl)] == 1
    assert got[("paddle_tpu_serving_cancellations_total", lbl)] == 1
    assert got[("paddle_tpu_serving_requests_total",
                (("engine_id", eid), ("event", "rejected"),
                 ("model_id", "m")))] == 1
    assert got[("paddle_tpu_serving_prefix_hits_total", lbl)] >= 1
    assert got[("paddle_tpu_serving_spec_drafted_tokens_total", lbl)] > 0
    counts = teng.compile_counts()
    assert counts["step"] == counts["step_buckets"] == got[(
        "paddle_tpu_jit_compiles_total",
        (("fn", "serving_step"), ("source", "fresh")))]
    # the exposition of the live registry parses
    fams = parse_prometheus(torch_metrics.get_registry().expose_prometheus())
    assert fams["paddle_tpu_serving_ttft_seconds"]["type"] == "histogram"


def _engine(tm, **kw):
    return ServingEngine(tm, page_size=4, max_batch_slots=2, device="cpu",
                         **kw)


def test_rejected_request_counts(models):
    engine = _engine(models[1])
    fam = torch_metrics.get_registry().get("paddle_tpu_serving_requests_total")
    child = fam.labels(event="rejected", engine_id=engine.engine_id,
                       model_id=engine.model_id)
    before = child.value
    with pytest.raises(ValueError):
        engine.add_request(np.arange(70), max_new_tokens=10)
    assert child.value == before + 1


def test_pool_capacity_gauge_self_heals_after_reset(models):
    reg = torch_metrics.get_registry()
    engine = _engine(models[1])
    child = reg.get("paddle_tpu_serving_kv_pages_total").labels(
        engine_id=engine.engine_id, model_id=engine.model_id)
    total = child.value
    assert total == engine.pool.usable_pages
    reg.reset()
    assert child.value == 0
    engine.add_request(np.arange(1, 5), max_new_tokens=2)
    engine.run()
    assert child.value == total


def test_engine_stats_is_thin_view_and_gauges_follow(models):
    reg = torch_metrics.get_registry()
    engine = _engine(models[1])
    engine.add_request(np.arange(1, 5), max_new_tokens=2)
    engine.run()
    assert engine.stats["finished_requests"] == 1
    assert np.isfinite(engine.stats["tokens_per_sec"])
    assert engine.stats["tokens_per_sec"] >= 0.0
    assert reg.get("paddle_tpu_serving_queue_depth").value == 0
    assert (reg.get("paddle_tpu_serving_page_utilization").value
            == engine.stats["page_utilization"])
    assert engine.health() == {"status": "ok", "watchdog_trips": 0,
                               "queue_depth": 0, "running_seqs": 0}
    assert engine.load_score() == 0.0 and engine.avg_step_s > 0


def test_disabled_registry_engine_records_nothing(models):
    """With the registry disabled, a served request moves no series (the
    instruments' switch that chip_smoke.py's on/off decode p50 reads)."""
    reg = torch_metrics.get_registry()
    engine = _engine(models[1])
    before = _raw(torch_metrics)
    reg.disable()
    try:
        rid = engine.add_request(np.arange(1, 5), max_new_tokens=3)
        assert engine.run()[rid].n_gen == 3
    finally:
        reg.enable()
    after = _raw(torch_metrics)
    moved = {k for k in after if after[k] != before.get(k, after[k])}
    assert moved == set()


def test_int8_scale_clips_match_jax():
    """``kv_dequant_scale_clip_total``: with the layers' k and v
    projections zero every written int8 slot's scale sits at the floor;
    the port counts them inside its step program, the JAX engine on the
    host after each step, and the two counts are equal (and equal the
    written slots x layers x kv heads x 2)."""
    import jax.numpy as jnp

    import paddle_tpu.metrics as jax_metrics

    widths = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                  num_key_value_heads=2, max_position_embeddings=64)
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny(**widths))
    for name, p in jm.named_parameters():
        if name.endswith(("k_proj.weight", "v_proj.weight")):
            p._value = jnp.zeros_like(p._value)
    tm = LlamaForCausalLM(llama_tiny(**widths), device="cpu")
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    name = "paddle_tpu_serving_kv_dequant_scale_clip_total"
    counts = []
    for eng, mod in ((JaxEngine(jm, page_size=4, max_batch_slots=2,
                                kv_dtype="int8"), jax_metrics),
                     (ServingEngine(tm, page_size=4, max_batch_slots=2,
                                    kv_dtype="int8", device="cpu"),
                      torch_metrics)):
        child = mod.get_registry().get(name).labels(
            engine_id=eng.engine_id, model_id=eng.model_id)
        for n in (5, 9):
            eng.add_request(np.arange(1, n + 1), max_new_tokens=3)
        eng.run()
        counts.append(child.value)
    # each request writes its prompt and all but its last token
    written = (5 + 2) + (9 + 2)
    assert counts[1] == counts[0] == written * 2 * 2 * 2
