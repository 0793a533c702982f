"""``route_build_s``: seconds the router takes to decide, and where it
takes the block or dense route to build, the view for each SpMM width of
the model (``adj.storage.hybrid(K_hint=K)`` in the forward's order), a
host-clock span, the card synchronised at both ends."""


def read(ctx):
    return ctx["spans"].get("route_build")
