from .dist_gcn import DistGCN  # noqa
from .gat import GAT  # noqa
from .gcn import GCN, gcn_norm, nll_loss  # noqa
from .gin import GIN  # noqa
from .sage import GraphSAGE  # noqa
