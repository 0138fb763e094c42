"""The realized sizes of the observed steps, averaged: what the per-layer
metrics count bytes and operations from. On a typed graph (the steps carry
``rels``) each block also gives ``valid_by_rel``: its mean valid slots of
each relation, by relation id. On a typed cell (the configuration has
``node_types``) each block also gives ``src_by_type`` and
``dst_by_type``, the mean live rows of each node type among its first
``num_src`` and ``num_dst`` frontier rows, and the sizes give
``relation_types``, each relation's ``[src type, dst type]`` by index."""

from __future__ import annotations

from typing import Dict, List

import torch


def _by_type(steps: List[Dict], offsets: torch.Tensor, k: int,
             col: int) -> List[float]:
    """The mean count of live rows of each node type (ids in
    ``[offsets[t], offsets[t + 1])``) among the first ``blocks[k][col]``
    frontier rows of each step."""
    t = offsets.shape[0] - 1
    count = torch.zeros(t, dtype=torch.int64)
    for s in steps:
        ids = s["frontier"][:int(s["blocks"][k][col])].long()
        ids = ids[ids >= 0]
        count += torch.bincount(
            torch.searchsorted(offsets, ids, right=True) - 1, minlength=t)
    return [int(c) / max(len(steps), 1) for c in count]


def realized(steps: List[Dict], cell: Dict) -> Dict:
    conf = cell["configuration"]
    n = max(len(steps), 1)
    types = conf.get("node_types")
    offsets = None
    if types:
        offsets = torch.tensor([0] + [int(t["num_nodes"]) for t in types],
                               dtype=torch.int64).cumsum(0)

    def mean(f) -> float:
        return sum(f(s) for s in steps) / n

    hops = len(steps[0]["blocks"]) if steps else 0
    blocks = []
    for k in range(hops):
        def blk(s, k=k):
            return s["blocks"][k]
        blocks.append({
            "slots": mean(lambda s: blk(s)[0].numel()),
            "valid": mean(lambda s: int(blk(s)[1].sum())),
            "distinct": mean(lambda s: int(torch.unique(
                blk(s)[0][blk(s)[1]]).numel())),
            "num_dst": mean(lambda s: blk(s)[3]),
            "num_src": mean(lambda s: blk(s)[2])})
        typed = [(s["rels"][k], blk(s)[1]) for s in steps
                 if s.get("rels") and s["rels"][k] is not None]
        if typed:
            r = len(conf["relations"])
            ids = [rel.long()[mask] for rel, mask in typed]
            count = sum(torch.bincount(v[(v >= 0) & (v < r)], minlength=r)
                        for v in ids)
            blocks[-1]["valid_by_rel"] = [int(c) / len(typed) for c in count]
        if offsets is not None:
            blocks[-1]["src_by_type"] = _by_type(steps, offsets, k, 2)
            blocks[-1]["dst_by_type"] = _by_type(steps, offsets, k, 3)
    x = next((s["x"] for s in steps if s.get("x") is not None), None)
    out = {"seeds": mean(lambda s: s["num_seeds"]),
           "hop1_rows": blocks[0]["num_src"] if blocks else 0.0,
           "frontier_rows": mean(lambda s: s["frontier"].numel()),
           "valid_rows": mean(lambda s: int((s["frontier"] >= 0).sum())),
           "blocks": blocks,
           "feature_dim": conf["feature_dim"],
           "num_classes": conf["num_classes"],
           "hidden_dim": conf["model"]["hidden_dim"],
           "row_itemsize": x.element_size() if x is not None else 4}
    if types:
        names = [t["name"] for t in types]
        out["relation_types"] = [[names.index(r["src"]),
                                  names.index(r["dst"])]
                                 for r in conf["relations"]]
    return out
