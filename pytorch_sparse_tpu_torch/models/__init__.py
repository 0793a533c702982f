from .gcn import GCN, gcn_norm  # noqa
