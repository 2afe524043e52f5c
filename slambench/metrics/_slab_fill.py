"""How full the tile-binning slabs were: the live entries the program's
binnings counted at their `bin` spans' paths (`slab_live`, under the
summary's "counters") over their slab rows (`slab_rows`), in percent,
summed over the binnings whose span path passes `inside`."""


def fill(ctx, inside) -> float | None:
    s = ctx["sections"].get("counters", {})
    live, rows = s.get("slab_live", {}).get("paths"), s.get("slab_rows", {}).get("paths")
    if not live or not rows:
        return None

    def total(paths, name):
        return sum(v["value"] for p, v in paths.items()
                   if inside(p.split("/")[:-1]) and p.endswith("/" + name))

    n_rows = total(rows, "slab_rows")
    return 100.0 * total(live, "slab_live") / n_rows if n_rows else None
