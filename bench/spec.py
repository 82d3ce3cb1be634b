"""What a cell is made of, found by name: ``BENCHMARK.json`` at the
checkout's root names each cell's configuration and traffic mix; the
configuration file (``bench/configs/<config>.json``, the path the
configuration's entry gives), the mix file (``bench/mixes/<traffic>.json``)
and the cell file (``bench/cells/<cell>.json``: the engine's slots and
rows, the reserved rate, found once by the knee sweep whose rows it keeps,
and the limits of the comparison that decides ``correct``) hold the
rest.  Each metric is read by a module of its own,
``bench/metrics/<metric>.py``.  A later cell or metric is new files and
new entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    params: dict

    @property
    def engine(self) -> dict:
        """The engine as this cell deploys it: ``max_batch`` slots of
        ``max_len`` rows, and the cache's dtype."""
        return self.params["engine"]

    @property
    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            f"bench.reference.{self.config['reference']}")


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=name, chips=w["chips"],
                config=load_json(ROOT / c["file"]),
                mix=load_json(BENCH / "mixes" / f"{w['traffic']}.json"),
                params=load_json(BENCH / "cells" / f"{name}.json"))


def metrics_for(name: str, kind: str, bench: dict | None = None) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
    reports: those without a ``workloads`` key and those that list it."""
    bench = bench or benchmark()
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(
        "bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------
# The configuration file against the program's own configuration
# --------------------------------------------------------------------------

#: configuration key -> (the program's ArchConfig field, how to read it)
_KEYS = {
    "hidden_size": lambda a: a.d_model,
    "num_attention_heads": lambda a: a.n_heads,
    "num_key_value_heads": lambda a: a.n_kv_heads,
    "head_dim": lambda a: a.head_dim_,
    "intermediate_size": lambda a: a.d_ff,
    "vocab_size": lambda a: a.vocab,
    "num_hidden_layers": lambda a: a.n_layers,
    "num_local_experts": lambda a: a.n_experts,
    "num_experts_per_tok": lambda a: a.top_k,
    "rope_theta": lambda a: a.rope_theta,
    "sliding_window": lambda a: a.window if set(a.layer_pattern) == {"local"}
    else None,
    "tie_word_embeddings": lambda a: a.tie_embeddings,
    "hidden_act": lambda a: {"silu": "silu",
                             "gelu": "gelu_pytorch_tanh"}[a.act],
}
_SERVED = {
    "norm": lambda a: {"rmsnorm": "rms_norm", "layernorm": "layer_norm"}[
        a.norm],
    "norm_eps": lambda a: 1e-6 if a.norm == "rmsnorm" else 1e-5,
    "mlp": lambda a: "gated" if a.gated_mlp else "plain",
    "bias": lambda a: "qkv" if a.qkv_bias else "none",
    "tied_logit_scale": lambda a: a.tie_embeddings,
    "dtype": lambda a: a.dtype,
}


def program_config(cfg: dict):
    """The program's ``ArchConfig`` for a configuration file: its registry
    entry (``program.arch``) with ``program.replace`` applied, refused
    unless every key the file states is what the program runs."""
    from repro_torch.configs.registry import get_config
    prog = cfg["program"]
    arch = dataclasses.replace(get_config(prog["arch"]),
                               **prog.get("replace", {}))
    bad = []
    for key, get in _KEYS.items():
        want = cfg.get(key, 0 if key.startswith("num_") else None)
        if key == "head_dim" and want is None:
            want = cfg["hidden_size"] // cfg["num_attention_heads"]
        if get(arch) != want:
            bad.append(f"{key}: file {want!r}, program {get(arch)!r}")
    for key, get in _SERVED.items():
        if get(arch) != cfg["served_as"][key]:
            bad.append(f"served_as.{key}: file {cfg['served_as'][key]!r}, "
                       f"program {get(arch)!r}")
    if bad:
        raise ValueError(f"{cfg['name']}: the program does not run the "
                         f"configuration file: " + "; ".join(bad))
    return arch
