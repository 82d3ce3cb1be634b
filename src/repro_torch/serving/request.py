"""Serving request/tenant structures.

Port of ``src/repro/serving/request.py`` (a copy over the port's ``SLO``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.flow import SLO


@dataclasses.dataclass
class Tenant:
    tenant_id: int
    slo: SLO                      # tokens/s (IOPS kind) guarantee
    policy: str = "reserved"      # reserved | on_demand | managed_burst | opportunistic
    weight: float = 1.0


@dataclasses.dataclass
class Request:
    req_id: int
    tenant_id: int
    prompt: "list[int]"
    max_new_tokens: int
    arrive_s: float = 0.0
    # runtime state
    slot: int = -1
    generated: "list[int]" = dataclasses.field(default_factory=list)
    prefill_done_s: float = float("nan")
    finish_s: float = float("nan")
    first_token_s: float = float("nan")

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens
