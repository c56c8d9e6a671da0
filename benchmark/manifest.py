"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is looked up by its name and brings:

* its configuration: the JSON file that the ``configs`` entry names;
* its traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``driver``
  names the general driver (``benchmark/drivers/<driver>.py``) that runs it;
* its own file, ``benchmark/workloads/<cell>.json``: the limits of the
  numbers that decide ``correct``, how much of a run they read, and how
  much of the window a ``--trace 1`` run profiles;
* its metrics: each metric of ``end_to_end`` and ``per_layer`` is read by
  ``benchmark/metrics/<metric>.py``.

So a configuration, a mix, a cell or a metric is added by adding files and
entries, without editing a file that is there. ``problems`` checks the
manifest against the benchmark's contract (names, units, keys, bounds).
"""

from __future__ import annotations

import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = SOURCES_E2E + ("program_span", "program_counter")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(manifest: dict, name: str, root: str = ROOT) -> dict:
    """Everything one cell needs, read from its files."""
    entry = by_name(manifest["workloads"], name, "workload")
    conf = by_name(manifest["configs"], entry["config"], "configuration")
    traffic = _json(os.path.join(root, "benchmark", "traffic",
                                 entry["traffic"] + ".json"))
    return {"entry": entry, "config": _json(os.path.join(root, conf["file"])),
            "traffic": traffic,
            "cell": _json(os.path.join(root, "benchmark", "workloads",
                                       name + ".json"))}


def applies(metric: dict, cell_name: str, reported: set) -> bool:
    """Whether a cell reports a metric: it is listed under the metric's
    ``workloads``, or the metric lists none and the cell reports the
    end-to-end metric it moves (an end-to-end metric without the key is
    reported everywhere)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def metrics_for(manifest: dict, cell_name: str, trace: bool) -> list:
    e2e = [m for m in manifest["end_to_end"] if applies(m, cell_name, set())]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"] if applies(m, cell_name, names)]


def metric_file(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "metrics", name + ".py")


def problems(m: dict, root: str = ROOT) -> list:
    """What in the manifest breaks the benchmark's contract (empty: none)."""
    out = []

    def need(cond, msg):
        if not cond:
            out.append(msg)

    need(set(m) == TOP_KEYS, f"top-level keys {sorted(m)}")
    need(isinstance(m.get("run_seconds"), int)
         and 1 <= m["run_seconds"] <= 51, "run_seconds not in 1..51")
    cmd = m.get("command", [])
    need(0 < len(cmd) <= 32 and all(isinstance(w, str) and 0 < len(w) <= 200
                                    for w in cmd), "command")
    paths = m.get("paths", [])
    need(0 < len(paths) <= 16, "paths count")
    for p in paths:
        need(bool(PATH.match(p)) and not p.startswith("/")
             and ".." not in p.split("/"), f"path {p!r}")
    names = set()
    for kind, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS)):
        entries = m.get(kind, [])
        need(0 < len(entries) <= 24, f"{kind} count")
        for e in entries:
            need(set(e) == keys, f"{kind} {e.get('name')}: keys {sorted(e)}")
            need(bool(NAME.match(e.get("name", ""))), f"name {e.get('name')}")
            need(0 < len(e.get("why", "")) <= 200
                 and "\n" not in e["why"] and "\t" not in e["why"],
                 f"why of {e.get('name')}")
    confs = {c["name"]: c for c in m.get("configs", [])}
    for c in confs.values():
        need(len(c["reduced"]) <= 16 and all(NAME.match(k)
                                             for k in c["reduced"]),
             f"reduced of {c['name']}")
        need(any(c["file"].startswith(p.rstrip("/") + "/") for p in paths),
             f"file of {c['name']} outside paths")
        need(os.path.exists(os.path.join(root, c["file"])),
             f"file of {c['name']} missing")
        need(0 < len(c["source"]) <= 200, f"source of {c['name']}")
    pairs = set()
    cells = m.get("workloads", [])
    for w in cells:
        need(w["config"] in confs, f"cell {w['name']}: unknown config")
        need(w["chips"] in (1, 4), f"cell {w['name']}: chips")
        need(bool(NAME.match(w["traffic"])), f"cell {w['name']}: traffic")
        need((w["config"], w["traffic"]) not in pairs,
             f"cell {w['name']}: pair repeated")
        pairs.add((w["config"], w["traffic"]))
        need(os.path.exists(os.path.join(root, "benchmark", "workloads",
                                         w["name"] + ".json")),
             f"cell {w['name']}: no cell file")
        need(os.path.exists(os.path.join(root, "benchmark", "traffic",
                                         w["traffic"] + ".json")),
             f"cell {w['name']}: no traffic file")
    need(all(any(w["config"] == c for w in cells) for c in confs),
         "a configuration no cell uses")
    four = sum(w["chips"] == 4 for w in cells)
    need(four <= max(1, len(cells) // 4), "too many 4-chip cells")
    e2e, layers = m.get("end_to_end", []), m.get("per_layer", [])
    need(0 < len(e2e) <= 16 and 0 < len(layers) <= 128, "metric counts")
    need(any(x["name"] == "setup_s" for x in e2e), "no setup_s")
    cell_names = {w["name"] for w in cells}
    for x in e2e + layers:
        extra = {"workloads"}
        keys = E2E_KEYS if x in e2e else LAYER_KEYS
        need(keys <= set(x) <= keys | extra,
             f"metric {x.get('name')}: keys {sorted(x)}")
        need(bool(NAME.match(x["name"])), f"metric name {x['name']}")
        need(bool(UNIT.match(x["unit"])), f"unit of {x['name']}")
        need(x["better"] in ("lower", "higher"), f"better of {x['name']}")
        need(x["source"] in (SOURCES_E2E if x in e2e else SOURCES),
             f"source of {x['name']}")
        need(set(x.get("workloads", cell_names)) <= cell_names,
             f"workloads of {x['name']}")
        need(os.path.exists(metric_file(x["name"], root)),
             f"no reader for {x['name']}")
    for x in e2e:
        need(0.01 <= x["bound"] <= 0.25, f"bound of {x['name']}")
    e2e_names = {x["name"] for x in e2e}
    for x in layers:
        need(x["moves"] in e2e_names, f"{x['name']} moves {x['moves']}")
        need(0 < len(x["layer"]) <= 200 and "\n" not in x["layer"],
             f"layer of {x['name']}")
        for w in x.get("workloads", []):
            reports = [y for y in e2e if y["name"] == x["moves"]
                       and applies(y, w, set())]
            need(bool(reports), f"{x['name']}: {w} lacks {x['moves']}")
    for w in cells:
        mine = [x for x in e2e if applies(x, w["name"], set())]
        need(len(mine) >= 2, f"cell {w['name']}: end-to-end metrics")
        need(bool(metrics_for(m, w["name"], True)),
             f"cell {w['name']}: no per-layer metric")
    for x in e2e + layers:
        names_ok = x["name"] not in names
        need(names_ok, f"metric name {x['name']} repeated")
        names.add(x["name"])
    need(len(json.dumps(m)) <= 64 * 1024, "manifest over 64 KiB")
    return out
