from .convert import INDEX_DTYPE, ind2ptr, ptr2ind  # noqa
from .host_sort import lexsort2, lexsort2_decode, stable_argsort  # noqa
from .index_sort import index_sort, lexsort_rows  # noqa
from .profile import annotate, timed, trace  # noqa
from .serialize import load_npz, save_npz  # noqa

__all__ = ["INDEX_DTYPE", "ind2ptr", "ptr2ind", "lexsort2",
           "lexsort2_decode", "stable_argsort", "index_sort",
           "lexsort_rows", "save_npz", "load_npz", "trace", "annotate",
           "timed"]
