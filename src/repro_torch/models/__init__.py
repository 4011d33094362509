from .attention import DecodePlan, PagedKVPool
from .convert import from_reference_params
from .ssm import SSMCache
from .transformer import Transformer, init_transformer

__all__ = ["DecodePlan", "PagedKVPool", "SSMCache", "Transformer",
           "from_reference_params", "init_transformer"]
