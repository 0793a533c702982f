"""Graph generators, one module each: ``generate(g, nodes, undirected_edges, params)``."""
