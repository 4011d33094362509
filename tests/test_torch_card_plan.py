"""What ``chip_smoke.py`` runs on one 80 GB card, checked on the CPU.

Every arch of the registry serves on the card and takes a held gradient
step there, and each run's depth is one whose bytes, reckoned from
``param_count()``, fit the card: serving's bf16 weights beside
``init_weights``' one f32 draw, the gradient hold's f32 copy and gradient
sets (12 bytes a parameter, 8 with the kernel run's gradients on the host),
and training's bf16 weights, gradients and clipped gradients beside the old
and the new f32 AdamW moments at the update (22). The script itself runs
only on a GPU; these cases only import it.
"""

import weakref

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.models.layers import init_weights  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402


@pytest.fixture(scope="module")
def cs():
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_serves_on_the_card_at_full_depth(cs, arch):
    served = set(cs.SERVE_ARCHS) | {cs.ARCH, cs.SSM_ARCH}
    assert arch in served
    assert not hasattr(cs, "CPU_ONLY_ARCHS")
    cfg = get_config(arch)
    assert cs.serve_bytes(cfg) <= cs.CARD_BYTES
    if arch in cs.SERVE_ARCHS:     # one flash forward a layer, 32 paged decodes a layer
        B, prompt, gen, want = cs.SERVE_ARCHS[arch]
        assert want["flash_attention_bwd"] == want["ssd_scan_bwd"] == want["adamw"] == 0
        if cfg.uses_attention and cfg.attention == "gqa" and cfg.window is None:
            assert want["flash_attention"] == cfg.num_layers
            assert want["paged_attention"] == cfg.num_layers * gen


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_takes_a_held_gradient_step_on_the_card(cs, arch):
    assert arch in cs.GRADS_BATCH
    cfg = cs.grads_cfg(arch)
    assert cfg.num_layers == cs.GRADS_LAYERS.get(arch, get_config(arch).num_layers)
    assert cs.grads_bytes(arch) <= cs.CARD_BYTES
    routed = cs.grads_cfg(arch, routed=True)
    if cfg.uses_moe:     # the f32 hold routes every token to every expert
        assert routed.top_k == routed.num_experts and routed.capacity_factor == 2.0
    else:
        assert routed == cfg


def test_gradient_hold_reckons_host_gradients(cs):
    """command-r-35b's 2 layers hold 67 GB at 12 bytes a parameter; its
    kernel run's gradients go to the host."""
    arch = "command-r-35b"
    assert arch in cs.GRADS_ON_HOST
    assert cs.grads_bytes(arch) == 8 * cs.grads_cfg(arch).param_count()
    assert 12 * cs.grads_cfg(arch).param_count() > 0.8 * cs.CARD_BYTES


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "musicgen-large"])
def test_train_archs_state_fits_the_card(cs, arch):
    assert arch in cs.TRAIN_ARCH_RUNS
    assert cs.train_bytes(arch) <= cs.CARD_BYTES
    cfg = cs.train_arch_cfg(arch)
    want = cs.train_launch_counts(cfg, 30)
    assert want["flash_attention"] == want["flash_attention_bwd"] == 30 * cfg.num_layers
    assert want["adamw"] == 60          # the norm and the update, a step


def test_train_launch_counts_take_the_cut_config(cs):
    from repro_torch.configs import replace
    hybrid = replace(get_config("hymba-1.5b"), num_layers=3)
    assert cs.train_launch_counts(hybrid, 2) == {
        "flash_attention": 6, "flash_attention_bwd": 6, "paged_attention": 0,
        "ring_attention": 0, "ssd_scan": 6, "ssd_scan_bwd": 6, "adamw": 4}
    # gradients alone (train_grads): no AdamW launch
    assert cs.train_launch_counts(hybrid, 1, updates=0)["adamw"] == 0
    ssm = get_config("mamba2-780m")
    assert cs.train_launch_counts(ssm, 1, forwards=2)["ssd_scan"] == 2 * ssm.num_layers


class LiveBytes(TorchDispatchMode):
    """The most bytes of tensors allocated under the mode (not views or
    in-place results of existing ones) alive at once."""

    def __init__(self):
        super().__init__()
        self.live, self.peak = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = {t.untyped_storage().data_ptr() for t in tree_flatten((args, kwargs))[0]
                 if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage().data_ptr()
            if key in given or key in self.live:
                continue
            self.live[key] = t.untyped_storage().nbytes()
            weakref.finalize(t, self.live.pop, key, None)
            self.peak = max(self.peak, sum(self.live.values()))
        return out


@pytest.mark.parametrize("arch", ["command-r-35b", "musicgen-large", "qwen2-moe-a2.7b"])
def test_init_weights_keeps_one_f32_draw_alive(arch):
    """init_weights scales each draw in place: its peak beside the weights is
    one f32 draw of the largest tensor (8.4 GB for command-r-35b's head at
    full width), where a scaled copy would double it past one card."""
    model = Transformer(get_reduced(arch), device="cpu")
    largest = max(p.numel() for p in model.parameters())
    with LiveBytes() as mode:
        init_weights(model, seed=0)
    assert mode.peak == 4 * largest
