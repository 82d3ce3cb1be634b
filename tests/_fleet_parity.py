"""Shared builders of the fleet control-plane parity tests
(``test_torch_resources.py``, ``test_torch_placement.py``,
``test_torch_control.py``, ``test_torch_controller.py``,
``test_torch_scenarios.py``): one namespace per
package holding the same names, so a scenario is written once and built
with the JAX package (``JAX``) and with the port on the CPU (``PORT``), and
the comparisons of their outputs."""
import dataclasses
import functools
import json
from types import SimpleNamespace

from _torch_parity import assert_results_equal


def _namespace(prefix: str, **extra) -> SimpleNamespace:
    import importlib
    mod = lambda name: importlib.import_module(  # noqa: E731
        f"{prefix}.core.{name}")
    flow, ic = mod("flow"), mod("interconnect")
    ns = SimpleNamespace(
        engine=mod("engine"), sim=mod("sim"), tb=mod("token_bucket"),
        profiler=mod("profiler"), placement=mod("placement"),
        control=mod("control"), controller=mod("controller"),
        runtime=mod("runtime"), telemetry=mod("telemetry"),
        CATALOG=mod("accelerator").CATALOG,
        AccelTable=mod("accelerator").AccelTable,
        FleetController=mod("controller").FleetController,
        TenantEvent=mod("controller").TenantEvent,
        SLO=flow.SLO, FlowSet=flow.FlowSet, FlowSpec=flow.FlowSpec,
        Path=flow.Path, TrafficPattern=flow.TrafficPattern,
        SLOKind=flow.SLOKind, LinkSpec=ic.LinkSpec, mem_bw=ic.mem_bw,
        host_dma=ic.host_dma, RES_MEM_BW=ic.RES_MEM_BW)
    ns.ArcusRuntime = mod("runtime").ArcusRuntime
    ns.workloads = importlib.import_module(f"{prefix}.workloads")
    ns.ProfileTable = mod("profiler").ProfileTable
    ns.simulate = ns.sim.simulate
    ns.simulate_batch = ns.sim.simulate_batch
    for k, v in extra.items():
        setattr(ns, k, functools.partial(getattr(ns, k), **v))
    return ns


#: the JAX package and the port (every entry point on the CPU)
JAX = _namespace("repro")
PORT = _namespace("repro_torch", ArcusRuntime=dict(device="cpu"),
                  ProfileTable=dict(device="cpu"),
                  simulate=dict(device="cpu"),
                  simulate_batch=dict(device="cpu"))


def report_json(reports) -> list:
    """Per-server lists of ``WindowReport.to_json()`` as JSON text (NaN
    latencies compare equal as text)."""
    return [[json.dumps(w.to_json(), sort_keys=True) for w in rep]
            for rep in reports]


def placements(placed) -> list:
    return [(p.accepted, p.server, p.accel_id, p.n_candidates, p.n_feasible,
             p.spec.flow_id) for p in placed]


def control_state(runtimes) -> list:
    """Every server's PerFlowStatusTable: registers, headroom, measured
    rate (as text: NaN), violations, reconfigurations, streak, path."""
    return [{fid: (dataclasses.astuple(st.params), st.headroom,
                   repr(st.measured), st.violations, st.reconfigs,
                   st.streak, int(st.spec.path), st.spec.accel_id)
             for fid, st in rt.table.items()} for rt in runtimes]


def assert_fleet_runs_equal(ref, port) -> None:
    """Two ``FleetController.run`` outputs agree: every server's last
    SimResult (counters and completion ring) and every WindowReport."""
    (res_r, rep_r), (res_p, rep_p) = ref, port
    assert len(res_r) == len(res_p)
    for a, b in zip(res_r, res_p):
        assert_results_equal(a, b)
    assert report_json(rep_r) == report_json(rep_p)
