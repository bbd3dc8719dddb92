"""Cells at a size a CPU test can run: the benchmark's own configuration
and traffic files with the sizes of the port's `tiny_config`."""

from __future__ import annotations

import copy

from slambench import cell as cell_mod

TINY = {
    "sensor": {"n_azimuth": 256},
    "preprocess": {"max_points": 2048},
    "keypoints": {"top_k": 64},
    "descriptor": {"max_neighbors": 64},
    "match": {"ransac_iterations": 128},
    "map": {"capacity": 4096},
    "runtime": {"point_tile": 256},
}
TINY_TRAFFIC = {"frames_per_lap": 5, "prefill_rows": 1024, "profile_start": 2,
                "profile_frames": 2, "check_chain": 2, "check_sampled": 2}
def tiny_cell(workload: str) -> cell_mod.Cell:
    """The cell `workload` of BENCHMARK.json cut to the tiny sizes."""
    cell = cell_mod.load(workload)
    config = copy.deepcopy(cell.config)
    for section, values in TINY.items():
        config[section].update(values)
    config["n_firings"] = 256
    cell.config, cell.traffic = config, dict(cell.traffic, **TINY_TRAFFIC)
    return cell
