"""What a cell is made of, found by name: `BENCHMARK.json`'s entry, its
configuration file, its traffic file, and the metric readers it reports.

A cell `<config>.<traffic>` reads `configs/<config>.json` (the file that
`BENCHMARK.json` names), `traffic/<traffic>.json` and the limits of its
correctness check, `limits/<cell>.json`; each metric is read by
`metrics/<metric name>.py`.  Nothing here names a cell, a
configuration or a metric: a later cell is a new entry and new files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    chips: int
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    limits: dict  # the correctness check's limit of each number compared


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench_path: pathlib.Path | None = None) -> Cell:
    """The cell called `workload` in `BENCHMARK.json` (at the checkout's
    root unless `bench_path`)."""
    bench_path = bench_path or ROOT / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((bench_path.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
    )


def reader(metric_name: str):
    """The `read(run)` function of `metrics/<metric_name>.py`."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def slam_config(config: dict):
    """The port's `SlamConfig` holding the configuration file's sections
    (lists become the tuples the dataclasses hold)."""
    from bshot_slam_tpu_torch import config as C

    sections = {f.name: f for f in dataclasses.fields(C.SlamConfig)}
    kwargs = {}
    for name, field in sections.items():
        cls = type(field.default_factory())
        vals = {k: tuple(v) if isinstance(v, list) else v
                for k, v in config[name].items()}
        kwargs[name] = cls(**vals)
    return C.SlamConfig(**kwargs)
