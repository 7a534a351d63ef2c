"""Cells cut to a size a CPU test run holds: a fortieth of each catalog, 6
levels, 512 points, a batch of 4 columns, a coarse Radau cache or
RadauEq(refine=2), few checked points; everything else as the cell states."""

from csbench import registry


def small_cell(name: str) -> dict:
    cell = registry.cell(registry.load_spec(), name)
    p = cell["params"]
    cut = {"catalog": {"gases": [dict(g, lines=max(40, g["lines"] // 40))
                                 for g in p["catalog"]["gases"]]},
           "atmosphere": {"levels": 6}, "points": 512, "trace_seconds": 0.2}
    if p["kind"] == "column_calls":
        cut["core"] = dict(p["core"], **({"nlevels": 24} if p["core"]["name"] == "Radau"
                                         else {"refine": 2}))
        cut["check"] = {"points": 32, "calls": 1, "n_sub": 4}
    else:
        cut["columns"] = 4
        cut["check"] = {"columns": 3}
    cell["params"] = registry.merge(p, cut)
    return cell


CELLS = [w["name"] for w in registry.load_spec()["workloads"]]
