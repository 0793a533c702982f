"""``build_s``: seconds from the edge list to the coalesced (and, for
GCN, normalised) ``SparseTensor``, a host-clock span around the calls
into the port's construction (``SparseTensor(row=, col=)``,
``coalesce``, the model's ``prepare``), the card synchronised at both
ends."""


def read(ctx):
    return ctx["spans"].get("build")
