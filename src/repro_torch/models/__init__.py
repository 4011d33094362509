from .attention import DecodePlan, PagedKVPool
from .convert import from_reference_params
from .transformer import Transformer, init_transformer

__all__ = ["DecodePlan", "PagedKVPool", "Transformer", "from_reference_params",
           "init_transformer"]
