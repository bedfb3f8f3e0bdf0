"""The port's kernel autotune (``repro_torch.kernels.autotune``) against
the reference's (``repro.kernels.autotune``), on the CPU.

* every kernel's space is the reference's: knob for knob (names, ladders,
  defaults, ``inert`` flags) and constraint for constraint; seeded random
  configs project to the same points;
* the reference's ``TestKernelSpaces`` / ``TestKernelEvaluator`` cases
  (``tests/test_kernels.py``) pass on CPU tensors, where the wrappers run
  their plain versions (no tiles: any positive knob);
* the instantiation-set checks (``resolve_tiles`` of each ops module, pure
  functions of the route and the knobs) refuse a tiling that is inside
  the space but outside a route's set, naming the set, and take every
  point they list;
* ``tune_kernel`` on the CPU returns the reference's keys with the space's
  default evaluated first (the card's own default second), and no ask of
  its strategy overlaps a timed window.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.kernels import autotune as rat
from repro_torch.core import strategy as ps
from repro_torch.core.service import EvalRequest, as_service
from repro_torch.kernels import autotune as pat
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gp_gram import ops as gram_ops
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops

KERNELS = ("flash_attention", "gp_gram", "mlstm_chunk")
SMALL = {"gp_gram": {"n": 24, "d": 3},
         "flash_attention": {"S": 32, "H": 2, "Kh": 1, "D": 16},
         "mlstm_chunk": {"S": 32, "H": 1, "P": 16}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _knobs(space):
    return [dataclasses.asdict(k) for k in space.knobs]


def _constraints(space):
    return [(type(c).__name__, tuple(c.knobs), getattr(c, "limit", None))
            for c in space.constraints]


# ---------------------------------------------------------------------------
# the spaces: the reference's
# ---------------------------------------------------------------------------

def test_registry_matches_the_reference():
    assert pat.tunable_kernels() == rat.tunable_kernels() == KERNELS
    with pytest.raises(KeyError):
        pat.kernel_space("nope")


@pytest.mark.parametrize("kernel", KERNELS)
def test_space_equals_the_reference(kernel):
    p, r = pat.kernel_space(kernel), rat.kernel_space(kernel)
    assert _knobs(p) == _knobs(r)
    assert _constraints(p) == _constraints(r)
    assert p.default_config() == r.default_config()
    assert pat.kernel_spec(kernel).default_config() == \
        rat.kernel_spec(kernel).default_config()


@pytest.mark.parametrize("kernel", KERNELS)
def test_projection_equals_the_reference(kernel):
    p, r = pat.kernel_space(kernel), rat.kernel_space(kernel)
    rng = np.random.default_rng(11)
    for _ in range(40):
        raw = {}
        for k in p.knobs:
            lo = min(k.choices) if k.choices else k.lo
            hi = max(k.choices) if k.choices else k.hi
            raw[k.name] = float(rng.uniform(lo / 2, hi * 1.5))
        got, want = p.project(dict(raw)), r.project(dict(raw))
        assert got == want
        assert p.validate(got) == r.validate(want) == []


# ---------------------------------------------------------------------------
# the reference's TestKernelSpaces / TestKernelEvaluator, on CPU tensors
# ---------------------------------------------------------------------------

class TestKernelSpaces:
    def test_tunable_registry(self):
        assert pat.tunable_kernels() == KERNELS
        for k in pat.tunable_kernels():
            sp = pat.kernel_space(k)
            dflt = sp.project(sp.default_config())
            assert sp.validate(dflt) == []

    def test_pow2_snap_and_product_constraint(self):
        sp = pat.kernel_space("gp_gram")
        p = sp.project({"block_n": 500, "block_m": 500,
                        "num_warps": 3, "pipeline": 2})
        assert p["block_n"] * p["block_m"] <= 256 * 256
        assert all(isinstance(p[k], int) and not isinstance(p[k], bool)
                   for k in ("block_n", "block_m", "num_warps"))
        assert p["num_warps"] in (2, 4)
        assert sp.validate(p) == []


class TestKernelEvaluator:
    def test_times_valid_config(self):
        ev = pat.KernelEvaluator("gp_gram", shape={"n": 24, "d": 3},
                                 repeats=1, warmup=1, device="cpu")
        assert ev(ev.spec.default_config()) > 0.0

    @pytest.mark.parametrize("kernel", KERNELS)
    def test_every_kernel_times_on_the_host(self, kernel):
        ev = pat.KernelEvaluator(kernel, shape=SMALL[kernel], repeats=1,
                                 warmup=1, device="cpu")
        assert ev(ev.spec.default_config()) > 0.0

    def test_invalid_config_fails_through_service(self):
        ev = pat.KernelEvaluator("gp_gram", shape={"n": 24, "d": 3},
                                 repeats=1, warmup=1, device="cpu")
        bad = dict(ev.spec.default_config())
        bad["block_n"] = 48                      # off the pow2 ladder
        with as_service(ev) as svc:
            ticket = svc.submit([EvalRequest(config=bad)])[0]
            res = svc.gather([ticket])[0]
        assert not res.ok
        assert "invalid config" in res.error

    def test_screen_fidelity_reduces_repeats(self):
        calls = []
        ev = pat.KernelEvaluator("gp_gram", shape={"n": 24, "d": 3},
                                 repeats=4, warmup=1, screen_repeats=1,
                                 device="cpu")
        build = ev._build

        def counting_build(cfg):
            run = build(cfg)

            def wrapped():
                calls.append(1)
                return run()
            return wrapped

        ev._build = counting_build
        cfg = ev.spec.default_config()
        ev(cfg, request=EvalRequest(config=cfg, fidelity="screen"))
        screen_calls = len(calls)
        calls.clear()
        ev(cfg, request=EvalRequest(config=cfg))
        assert screen_calls < len(calls)

    def test_service_kind_and_workers(self):
        ev = pat.KernelEvaluator("gp_gram", shape={"n": 24, "d": 3},
                                 device="cpu")
        assert ev.service_kind == "pool" and ev.max_workers == 1
        assert ev.wants_request is True


def test_gp_gram_rectangular_tiles_match_reference_on_cpu():
    """CPU tensors take the plain version: any positive tile gives the
    reference's function (the card's tilings are bit-equal to each
    other: tests/test_torch_autotune_cuda.py)."""
    from repro.kernels.gp_gram.ref import matern52_cross_ref
    rng = np.random.default_rng(9)
    xa, xb = rng.random((136, 9)), rng.random((77, 9))
    ls = rng.uniform(0.1, 1.0, 9)
    want = np.asarray(matern52_cross_ref(xa, xb, ls, 0.8))
    t = [torch.tensor(a, dtype=torch.float32) for a in (xa, xb, ls)]
    for bn, bm in ((64, 256), (256, 64), (32, 32)):
        got = gram_ops.matern52_cross(*t, 0.8, block=bn, block_m=bm,
                                      num_warps=3, pipeline=4)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    with pytest.raises(ValueError, match="positive"):
        gram_ops.matern52_gram(t[0], t[2], 1.0, block=0)


# ---------------------------------------------------------------------------
# the instantiation sets (pure functions: checked without a card)
# ---------------------------------------------------------------------------

def test_gp_gram_set():
    assert gram_ops.resolve_tiles() == gram_ops.DEFAULT_TILES == (32, 32, 8, 1)
    assert gram_ops.resolve_tiles(128, 128, 4, 2) == (128, 128, 4, 2)
    assert gram_ops.resolve_tiles(64) == (64, 64, 8, 1)     # square
    sp = pat.kernel_space("gp_gram")
    inside = {"block_n": 256, "block_m": 128, "num_warps": 4, "pipeline": 2}
    assert sp.validate(inside) == []
    with pytest.raises(ValueError, match=r"block_n in \(32, 64, 128\)"):
        gram_ops.resolve_tiles(256, 128, 4, 2)
    with pytest.raises(ValueError, match="no instantiation for block_m=8"):
        gram_ops.resolve_tiles(32, 8)
    n_ok = 0
    for bn in sp.knob("block_n").choices:
        for bm in sp.knob("block_m").choices:
            for nw in sp.knob("num_warps").choices:
                for st in range(1, 5):
                    cfg = {"block_n": bn, "block_m": bm, "num_warps": nw,
                           "pipeline": st}
                    try:
                        gram_ops.resolve_tiles(bn, bm, nw, st)
                    except ValueError:
                        continue
                    assert sp.validate(cfg) == []
                    n_ok += 1
    assert n_ok == 3 * 3 * 4 * 4


@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_set(D):
    bf16 = torch.bfloat16
    tiles = flash_ops.supported_tiles("wgmma", bf16, D)
    assert tiles[0] == flash_ops.DEFAULT_TILES["wgmma"] == (128, 128, 4, 2)
    assert len(set(tiles)) == len(tiles)
    assert all(flash_ops._wgmma_smem(D, bq, bk, st) <= 232448
               for bq, bk, _, st in tiles)
    assert ((128, 128, 4, 4) in tiles) == (D == 64)     # 227 KB at D 128
    assert flash_ops.resolve_tiles("wgmma", bf16, D, 4096, 4096) == tiles[0]
    # the space's default (512 x 512) is inside the space, not in the set
    with pytest.raises(ValueError, match=r"\(block_q, block_k, num_warps, "
                       r"pipeline\) in"):
        flash_ops.resolve_tiles("wgmma", bf16, D, 4096, 4096, 512, 512, 4, 2)
    with pytest.raises(ValueError, match="num_warps=8"):
        flash_ops.resolve_tiles("wgmma", bf16, D, 4096, 4096, 128, 128, 8, 2)
    for t in tiles:
        assert flash_ops.resolve_tiles("wgmma", bf16, D, 4096, 4096,
                                       *t) == t


def test_flash_fma_set_and_clamp():
    f32 = torch.float32
    tiles = flash_ops.supported_tiles("fma", f32, 64)
    assert tiles[0] == flash_ops.DEFAULT_TILES["fma"] == (64, 64, 8, 1)
    assert len(tiles) == 1 + len(flash_ops.FMA_TILES)
    for bq, bk, nw, st in tiles:
        assert st == 1 and bq % (2 * nw) == 0 and 2 <= bq // (2 * nw) <= 8
    # other dtypes and head dims: the default tile only
    assert flash_ops.supported_tiles("fma", torch.bfloat16, 32) == tiles[:1]
    assert flash_ops.supported_tiles("fma", f32, 256) == tiles[:1]
    with pytest.raises(ValueError, match="pipeline=2"):
        flash_ops.resolve_tiles("fma", f32, 64, 192, 192, 64, 64, 8, 2)
    # clamped to the sequence's power-of-two ceiling, as the reference
    # clamps to the sequence: 128 rows on a 40-row sequence run 64
    assert flash_ops.resolve_tiles("fma", f32, 64, 40, 40, 128, 64, 8,
                                   1) == (64, 64, 8, 1)
    # no lower than the route's smallest tile: 16 rows, 32 keys
    assert flash_ops.resolve_tiles("fma", f32, 64, 8, 8, 32, 32, 2,
                                   1) == (16, 32, 2, 1)
    with pytest.raises(ValueError):                     # 512 -> 256
        flash_ops.resolve_tiles("fma", f32, 64, 192, 192, 512, 512, 4, 1)


def test_mlstm_sets():
    assert mlstm_ops.supported_tiles("fma", 32, 256) == ((8, 1), (4, 1))
    with pytest.raises(ValueError, match=r"\(8, 1\), \(4, 1\)"):
        mlstm_ops.resolve_tiles("fma", 32, 256, 4, 2)   # the space default
    for c, default in ((128, (8, 3)), (256, (8, 3)), (512, (4, 3)),
                       (1024, (4, 3))):
        tiles = mlstm_ops.supported_tiles("wgmma", 1024, c)
        assert tiles[0] == default == mlstm_ops.resolve_tiles(
            "wgmma", 1024, c)
        assert len(tiles) == (4 if c == 1024 else 8)
        assert mlstm_ops.resolve_tiles("wgmma", 1024, c, 4, 2) == (4, 2)
    with pytest.raises(ValueError, match="num_warps=8"):
        mlstm_ops.resolve_tiles("wgmma", 1024, 1024, 8, 3)
    with pytest.raises(ValueError, match="num_warps=2"):
        mlstm_ops.resolve_tiles("wgmma", 1024, 256, 2, 3)


@pytest.mark.parametrize("kernel, shape, route_tiles", [
    ("gp_gram", {}, lambda c: gram_ops.resolve_tiles(
        c["block_n"], c["block_m"], c["num_warps"], c["pipeline"])),
    ("flash_attention", {"D": 128, "dtype": "bfloat16"},
     lambda c: flash_ops.resolve_tiles(
         "wgmma", torch.bfloat16, 128, 4096, 4096, *c.values())),
    ("flash_attention", {}, lambda c: flash_ops.resolve_tiles(
        "fma", torch.float32, 64, 192, 192, *c.values())),
    ("mlstm_chunk", {"S": 4096, "P": 1024, "dtype": "bfloat16"},
     lambda c: mlstm_ops.resolve_tiles(
         "wgmma", 1024, c["chunk"], c["num_warps"], c["pipeline"])),
    ("mlstm_chunk", {}, lambda c: mlstm_ops.resolve_tiles(
        "fma", 32, c["chunk"], c["num_warps"], c["pipeline"])),
])
def test_native_is_a_point_the_card_takes(kernel, shape, route_tiles):
    spec = pat.kernel_spec(kernel)
    native = spec.native(**shape)
    assert spec.space.validate(native) == []
    assert spec.space.project(dict(native)) == native
    route_tiles(native)                        # does not raise


def test_cpu_tensors_take_any_positive_knob():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 24, 2, 16), generator=g)
    base = flash_ops.flash_attention(q, q, q)
    odd = flash_ops.flash_attention(q, q, q, block_q=24, block_k=1000,
                                    num_warps=3, pipeline=7)
    assert torch.equal(base, odd)
    with pytest.raises(ValueError, match="positive"):
        flash_ops.flash_attention(q, q, q, num_warps=0)
    gates = torch.randn((1, 24, 2), generator=g)
    h = mlstm_ops.mlstm_chunk(q, q, q, gates, -gates.abs(), chunk=8,
                              num_warps=3, pipeline=9)
    assert torch.equal(h, mlstm_ops.mlstm_chunk(q, q, q, gates, -gates.abs(),
                                                chunk=8))
    with pytest.raises(ValueError, match="positive"):
        mlstm_ops.mlstm_chunk(q, q, q, gates, gates, chunk=8, pipeline=-1)


# ---------------------------------------------------------------------------
# tune_kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_tune_kernel_returns_the_reference_keys(kernel):
    out = pat.tune_kernel(kernel, shape=SMALL[kernel], budget=6,
                          repeats=1, warmup=1, fit_steps=10, device="cpu")
    assert set(out) == {"best_config", "best_value", "default_config",
                        "default_value", "trace", "db"}
    sp = pat.kernel_space(kernel)
    assert out["default_config"] == sp.project(sp.default_config())
    trace = out["trace"]
    assert len(trace.values) == 6
    assert trace.configs[0] == out["default_config"]     # evaluated first
    native = sp.project(pat.kernel_spec(kernel).native(**SMALL[kernel]))
    if native != out["default_config"]:
        assert trace.configs[1] == native
    assert out["default_value"] == trace.values[0] > 0
    assert out["best_value"] == min(trace.values)
    assert sp.validate(out["best_config"]) == []


def test_no_ask_overlaps_a_timed_window(monkeypatch):
    """The tuner's ask (its GP fit and selection) holds the evaluator's
    timing lock: no timed window runs while it runs."""
    spans, lock = [], threading.Lock()

    def record(kind, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    spans.append((kind, t0, time.perf_counter()))
        return wrapped

    monkeypatch.setattr(ps.BOStrategy, "ask",
                        record("ask", ps.BOStrategy.ask))
    bench = pat.kernel_spec("gp_gram").bench

    def slow_bench(**shape):
        build = bench(**shape)

        def timed_build(cfg):
            run = build(cfg)
            return record("run", lambda: (time.sleep(0.002), run())[1])
        return timed_build
    spec = pat.kernel_spec("gp_gram")
    monkeypatch.setitem(pat._REGISTRY, "gp_gram",
                        dataclasses.replace(spec, bench=slow_bench))
    pat.tune_kernel("gp_gram", shape={"n": 24, "d": 3}, budget=10,
                    batch_size=2, repeats=2, warmup=1, fit_steps=10,
                    device="cpu")
    asks = [s for s in spans if s[0] == "ask"]
    runs = [s for s in spans if s[0] == "run"]
    assert len(asks) > 3 and len(runs) >= 10 * 3
    for _, a0, a1 in asks:
        for _, r0, r1 in runs:
            assert r1 <= a0 or a1 <= r0
