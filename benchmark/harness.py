"""What a run of one cell is made of, found by name: the cell in
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic (``traffic/<traffic>.json``), its limits and controls
(``workloads/<cell>.json``), its driver (``drivers/<driver>.py``) and the
readers of its per-layer metrics (``metrics/<metric>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_part_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    checks: dict         # workloads/<cell>.json
    end_to_end: list     # the end-to-end metrics the cell reports
    per_layer: list      # the per-layer metrics the cell reports


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    checks = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(name, entry, config, traffic, checks,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def driver(cell: Cell):
    return load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py")


def port_config(cell: Cell, overrides: dict | None = None):
    """The port's ``Config`` the cell runs: the traffic's recipe (a preset
    of the port: its audio and inference settings), the configuration's
    model, training and audio sections over it. ``overrides``: {section:
    {key: value}} on top (the tests' small sizes)."""
    from tacotron_tpu_torch.config import PRESETS, AudioConfig, ModelConfig, TrainConfig

    base = PRESETS[cell.traffic["preset"]]
    sections = {"model": ModelConfig, "train": TrainConfig, "audio": AudioConfig}
    kw = {}
    for sec, cls in sections.items():
        values = {**(dataclasses.asdict(base.audio) if sec == "audio" else {}),
                  **cell.config.get(sec, {}), **(overrides or {}).get(sec, {})}
        kw[sec] = cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in values.items()})
    infer = dataclasses.replace(base.infer, **(overrides or {}).get("infer", {}))
    return base.replace(infer=infer, name=cell.name, **kw)


def plain(cfg) -> dict:
    """A port ``Config`` as the plain dicts the reference reads."""
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in ("model", "audio", "infer", "train")}
