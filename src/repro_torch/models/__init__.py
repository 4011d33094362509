from .attention import DecodePlan, PagedKVPool, RingKVCache, SlotCache, SlotPlan
from .convert import from_reference_params
from .mla import LatentCache
from .moe import moe_apply
from .ssm import SSMCache
from .transformer import Cache, HybridCache, Transformer, init_transformer, loss_fn

__all__ = ["Cache", "DecodePlan", "HybridCache", "LatentCache", "PagedKVPool",
           "RingKVCache", "SSMCache", "SlotCache", "SlotPlan", "Transformer",
           "from_reference_params", "init_transformer", "loss_fn", "moe_apply"]
