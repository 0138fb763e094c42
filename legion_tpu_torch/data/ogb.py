"""OGB node-property dataset -> packed directory (counterpart of
``legion_tpu/data/ogb.py``).

One entry point, ``convert_ogb_node_dataset``, with the reference's
arguments, steps and output: the files it writes are byte-equal to the
reference converter's for the same source. It needs the ``ogb`` package
and a downloaded dataset (or any module served as ``ogb.nodeproppred``
with a ``NodePropPredDataset`` of the same interface, as the tests and
``tools/products_cell.py`` do); the import is made only when it runs.

    python -c "from legion_tpu_torch.data.ogb import convert_ogb_node_dataset as c; \\
               c('ogbn-products', '/data/ogb', '/data/products_packed')"
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from legion_tpu_torch.data.format import GraphData, save_dataset


def convert_ogb_node_dataset(name: str, root: str, out_path: str,
                             add_reverse: bool = True,
                             partitions: Optional[int] = None) -> GraphData:
    """Convert an OGB node-property dataset (ogbn-arxiv, ogbn-products,
    ogbn-papers100M, ...) into the packed layout at ``out_path`` and
    return it as a ``GraphData``.

    ``add_reverse`` treats the graph as undirected by adding every edge's
    reverse (the GraphSAGE baselines' convention on products and
    papers100M). The CSR groups edges by destination in the order given
    (``runtime.coo_to_csr``, which raises on a destination outside the
    nodes); NaN labels (unlabelled nodes) become -1. ``partitions=k``
    also writes the greedy k-way partition file ``partition_<k>_bn``."""
    from ogb.nodeproppred import NodePropPredDataset  # optional dependency

    from legion_tpu_torch.runtime import coo_to_csr

    ds = NodePropPredDataset(name=name, root=root)
    graph, labels = ds[0]
    split = ds.get_idx_split()
    n = int(graph["num_nodes"])
    src, dst = graph["edge_index"][0], graph["edge_index"][1]
    if add_reverse:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    indptr, indices = coo_to_csr(src, dst, n)
    del src, dst

    lab = np.asarray(labels).reshape(-1)
    lab = np.where(np.isnan(lab), -1, lab).astype(np.int32)
    g = GraphData(
        indptr=indptr, indices=indices,
        features=np.ascontiguousarray(graph["node_feat"], np.float32),
        labels=lab,
        train_ids=np.asarray(split["train"], np.int32),
        valid_ids=np.asarray(split["valid"], np.int32),
        test_ids=np.asarray(split["test"], np.int32),
    )
    if partitions:
        from legion_tpu_torch.data.partition import partition_graph
        g.partition = partition_graph(g, partitions)
    save_dataset(g, out_path)
    return g
