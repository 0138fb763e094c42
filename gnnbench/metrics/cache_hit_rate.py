"""The cached trainer's own hit rate (hits over valid frontier rows),
averaged over the traced epochs, in percent."""

UNIT, LAYER, MOVES = "%", "cache pipeline", "train_edges_per_s"


def read(ctx):
    t = ctx["trace"]
    recs = [r for r in (t["records"] if t else []) if "hit_rate" in r]
    if not recs:
        return None
    return 100.0 * sum(r["hit_rate"] for r in recs) / len(recs)
