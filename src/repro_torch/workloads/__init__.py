"""Production-shaped workload subsystem (port of ``src/repro/workloads``).

``repro_torch.workloads.generators`` registers the production-shaped
arrival processes (MMPP, heavy-tailed sizes, diurnal, correlated
cross-tenant bursts, flash crowds, adversarial token-bucket probing) into
the port's arrival-process registry, in the reference's order;
``repro_torch.workloads.scenarios`` composes them into named, replayable
fleet scenarios.

Importing this package is enough to make every generator available to
``TrafficPattern(process=...)`` across all existing entry points
(``gen_arrivals`` / ``stack_arrivals`` / ``run_system_batch`` /
``FleetController.run``).
"""
from repro_torch.workloads import generators  # noqa: F401 (registers)
from repro_torch.workloads.scenarios import (SCENARIOS,  # noqa: F401
                                             BuiltScenario, ScenarioSpec,
                                             get_scenario, load_trace,
                                             register_scenario, save_trace,
                                             scenario_names)
