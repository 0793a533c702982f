"""``block_edge_pct``: the share of the adjacency's edges that the
router's cached view serves from dense blocks (``dense_nnz`` over
``nnz``), 0 where every width took the CSR route."""


def read(ctx):
    route = ctx.get("route")
    if not route or not route.get("nnz"):
        return None
    return 100.0 * route["dense_nnz"] / route["nnz"]
