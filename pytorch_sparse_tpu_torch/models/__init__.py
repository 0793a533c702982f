from .gat import GAT  # noqa
from .gcn import GCN, gcn_norm  # noqa
