"""Port parity of the named fleet scenarios
(``repro_torch.workloads.scenarios``) against the JAX package's: the
registry, each scenario's tenants and events, builds (lane maps, seeds,
lane-ordered arrival traces) and ``FleetController.run`` of the five
scenarios shrunk in time (windows of 150 ticks, four of them), under
``StaticHold`` and, for the flash crowd and the adversarial prober, under
``GlobalRetarget(SlackAIMD())``; and the trace files, which either package
writes and the other reads.

Scenarios admit against 8,000-tick profiles.  The port's CPU tick costs
milliseconds, so the reference's ProfileTable is carried across instead
(``to_json`` after the reference's run, the port's ``from_json``): the
port's run then profiles nothing, and its admissions and mid-run arrivals
still go through ``profile_contexts_multi``'s cache path."""
import dataclasses

import numpy as np
import pytest
import torch

from _fleet_parity import JAX, PORT, assert_fleet_runs_equal
from repro_torch.core import profiler as tprof
from _torch_parity import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


NAMES = ("mmpp_surge", "heavy_tail", "diurnal_corr", "flash_crowd",
         "adversarial_probe")
PROFILE_TICKS = 8_000
WINDOW, N_WINDOWS = 150, 4
ARMS = {"static": lambda ns: ns.control.StaticHold(),
        "adaptive": lambda ns: ns.control.GlobalRetarget(
            ns.control.SlackAIMD(), period=3)}


def _spec(ns, name):
    """The named scenario shrunk in time; ``dataclasses.replace`` so the
    window-locked knobs (the prober's period) are derived again."""
    return dataclasses.replace(ns.workloads.get_scenario(name),
                               window_ticks=WINDOW, n_windows=N_WINDOWS)


def _build(ns, spec, **kw):
    if ns is PORT:
        kw["device"] = "cpu"
    return spec.build(**kw)


class _Runs:
    """The reference's builds and runs, made once a module, and the port's
    ProfileTable carried from the reference's."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.profile = JAX.ProfileTable(n_ticks=PROFILE_TICKS)
        self.runs = {}

    def jax(self, name, arm="static"):
        if (name, arm) not in self.runs:
            built = _build(JAX, _spec(JAX, name), control=ARMS[arm](JAX),
                           profile=self.profile)
            self.runs[name, arm] = (built, built.run())
        return self.runs[name, arm]

    def port_profile(self):
        path = self.tmp / "profile.json"
        self.profile.to_json(str(path))
        table = PORT.profiler.ProfileTable.from_json(str(path),
                                                     device="cpu")
        table.n_ticks = PROFILE_TICKS
        return table


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("scenarios"))


def _port_run(runs, name, arm="static", **kw):
    """Build and run the port's scenario against the carried table; the
    run must profile nothing."""
    built = _build(PORT, _spec(PORT, name), control=ARMS[arm](PORT),
                   profile=runs.port_profile(), **kw)
    before = tprof.profiling_stats()["contexts"]
    out = built.run()
    assert tprof.profiling_stats()["contexts"] == before
    return built, out


def _assert_builds_equal(ref, port):
    assert port.lane_maps == ref.lane_maps
    assert port.run_kwargs["seeds"] == ref.run_kwargs["seeds"]
    assert port.run_kwargs["load_ref_gbps"] == ref.run_kwargs["load_ref_gbps"]
    assert port.clock_hz == ref.clock_hz
    assert len(port.arrivals) == len(ref.arrivals)
    for (t1, s1), (t2, s2) in zip(ref.arrivals, port.arrivals):
        assert t2.dtype == np.int32 and s2.dtype == np.int32
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(s1, s2)


# --- registry and specs ------------------------------------------------------


def test_scenario_registry():
    assert PORT.workloads.scenario_names() == NAMES
    assert PORT.workloads.scenario_names() == \
        JAX.workloads.scenario_names()[:len(NAMES)]
    with pytest.raises(KeyError, match="mmpp_surge"):   # lists the registry
        PORT.workloads.get_scenario("no_such_scenario")
    spec = PORT.workloads.get_scenario("mmpp_surge")
    with pytest.raises(ValueError, match="already registered"):
        PORT.workloads.register_scenario(spec)
    assert PORT.workloads.register_scenario(spec, replace=True) is spec


def _as_plain(x):
    """A spec's dataclasses as nested tuples of plain values (the two
    packages' classes differ; their enums compare as ints)."""
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shrunk", [False, True])
def test_scenario_specs_match_reference(name, shrunk):
    """Every field, each tenant and each event of the scenario equal the
    reference's, at full size (where the prober's period is 12 windows)
    and shrunk (where it is derived again)."""
    get = _spec if shrunk else (lambda ns, n: ns.workloads.get_scenario(n))
    ref, port = get(JAX, name), get(PORT, name)
    for f in dataclasses.fields(ref):
        if f.name not in ("tenants", "events"):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.total_ticks, port.window_s(), port.horizon_s()) == \
        (ref.total_ticks, ref.window_s(), ref.horizon_s())
    assert [[_as_plain(s) for s in lst] for lst in port.tenants(port)] == \
        [[_as_plain(s) for s in lst] for lst in ref.tenants(ref)]
    assert (port.events is None) == (ref.events is None)
    if ref.events is not None:
        assert [(e.window, e.kind, _as_plain(e.spec), e.tenant_id, e.server,
                 e.accel_name) for e in port.events(port)] == \
            [(e.window, e.kind, _as_plain(e.spec), e.tenant_id, e.server,
              e.accel_name) for e in ref.events(ref)]


def test_build_without_a_device_raises(monkeypatch):
    """Without CUDA and without ``device="cpu"`` the build raises (the
    ProfileTable it makes, or the runtimes)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec(PORT, "mmpp_surge")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build(profile=PORT.ProfileTable(n_ticks=PROFILE_TICKS))


# --- builds and runs ---------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_scenario_static_run_matches_reference(runs, name):
    """The build (lane maps, seeds, arrival traces) and the ``StaticHold``
    run (every server's counters and completion ring, every WindowReport,
    the lifecycle events) equal the reference's."""
    ref_built, ref_out = runs.jax(name)
    built, out = _port_run(runs, name)
    _assert_builds_equal(ref_built, built)
    assert_fleet_runs_equal(ref_out, out)
    assert built.controller.last_events == ref_built.controller.last_events
    if name == "flash_crowd":       # both opportunists admitted mid-run
        assert [e["kind"] for e in built.controller.last_events] == \
            ["arrive", "arrive"]
        assert all(e["server"] is not None
                   for e in built.controller.last_events)


@pytest.mark.parametrize("name", ["flash_crowd", "adversarial_probe"])
def test_scenario_adaptive_run_matches_reference(runs, name):
    """The bi-level adaptive policy's run equals the reference's, and so
    do the registers it left behind."""
    ref_built, ref_out = runs.jax(name, "adaptive")
    built, out = _port_run(runs, name, "adaptive")
    assert_fleet_runs_equal(ref_out, out)
    assert built.controller.last_events == ref_built.controller.last_events
    regs = [{f: dataclasses.astuple(st.params) for f, st in rt.table.items()}
            for rt in built.controller.runtimes]
    assert regs == [{f: dataclasses.astuple(st.params)
                     for f, st in rt.table.items()}
                    for rt in ref_built.controller.runtimes]


# --- trace files -------------------------------------------------------------


@pytest.mark.parametrize("ext", [".json", ".npz"])
def test_trace_roundtrip_across_packages(runs, tmp_path, ext):
    """A trace saved by either package loads in both, bit for bit, with
    its meta; the JSON files are the same bytes."""
    ref_built, _ = runs.jax("flash_crowd")
    built = _build(PORT, _spec(PORT, "flash_crowd"),
                   profile=runs.port_profile())
    meta = {"scenario": "flash_crowd", "seed": 17}
    paths = {}
    for ns, b in ((JAX, ref_built), (PORT, built)):
        paths[id(ns)] = tmp_path / f"{ns.workloads.__name__}{ext}"
        ns.workloads.save_trace(paths[id(ns)], b.arrivals, meta=meta)
    for path in paths.values():
        for ns in (JAX, PORT):
            arr, got_meta = ns.workloads.load_trace(path)
            assert got_meta == meta
            assert len(arr) == len(ref_built.arrivals)
            for (t1, s1), (t2, s2) in zip(ref_built.arrivals, arr):
                assert t2.dtype == np.int32 and s2.dtype == np.int32
                np.testing.assert_array_equal(t1, t2)
                np.testing.assert_array_equal(s1, s2)
    if ext == ".json":
        assert paths[id(JAX)].read_bytes() == paths[id(PORT)].read_bytes()
    else:
        with np.load(paths[id(JAX)]) as a, np.load(paths[id(PORT)]) as b:
            assert sorted(a.files) == sorted(b.files)
    with pytest.raises(ValueError, match="json or .npz"):
        PORT.workloads.save_trace(tmp_path / "trace.txt", built.arrivals)
    with pytest.raises(ValueError, match="json or .npz"):
        PORT.workloads.load_trace(tmp_path / "trace.txt")


def test_replayed_trace_reproduces_the_run(runs, tmp_path):
    """The reference's trace, saved by the reference and loaded by the
    port, replays through ``build(arrivals=...)`` into the reference's
    run: counters, completion rings, reports and the mid-run arrivals
    (whose traces regenerate from the same per-event seeds)."""
    ref_built, ref_out = runs.jax("flash_crowd")
    JAX.workloads.save_trace(tmp_path / "t.npz", ref_built.arrivals,
                             meta={"scenario": "flash_crowd"})
    arr, meta = PORT.workloads.load_trace(tmp_path / "t.npz")
    assert meta == {"scenario": "flash_crowd"}
    built, out = _port_run(runs, "flash_crowd", arrivals=arr)
    assert_fleet_runs_equal(ref_out, out)
    assert built.controller.last_events == ref_built.controller.last_events
