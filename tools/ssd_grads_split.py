"""Which half of the SSD scan moves full-width f32 gradients off the plain path.

``chip_smoke.py``'s ``train_grads`` holds each parameter's f32 gradient
through the kernels within 1e-4 (relative norm) of the gradient with the
plain versions swapped in. This splits that difference for mamba2-780m and
hymba-1.5b (f32 copies of the seed-0 weights, one batch of B 4, S 512, as
``train_grads`` draws them): the scan's forward and backward are each the
kernel (K) or the plain version (P); KK, KP and PK are held against PP, and
SP puts serving's forward (3×TF32 tensor-core products, cs summed in f32)
under training in place of the training forward (exact f32, cs in f64),
with the training forward's chunk states and the plain backward. Flash
attention (hymba) runs its kernels except in PP. Prints the three worst
parameters of each case, and the card's name and power limit::

    python tools/ssd_grads_split.py
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_bwd_ref  # noqa: E402
from repro_torch.models import init_transformer, loss_fn  # noqa: E402

BATCH, SEQ = 4, 512


@contextlib.contextmanager
def scan_halves(fwd: str, bwd: str):
    """The scan's forward ("K" kernel, "P" plain, "S" serving's kernel) and
    backward ("K" or "P") within the block."""
    launch, launch_bwd = ssd._launch, ssd._launch_bwd

    def plain_fwd(x, Bm, Cm, dt, A, chunk, return_state, with_states=False):
        return ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk, return_states=with_states,
                           cs64=with_states)

    def serving_fwd(x, Bm, Cm, dt, A, chunk, return_state, with_states=False):
        y, h = launch(x, Bm, Cm, dt, A, chunk, True)
        return (y, h, launch(x, Bm, Cm, dt, A, chunk, True, with_states=True)[2]) \
            if with_states else (y, h)

    if fwd != "K":
        ssd._launch = plain_fwd if fwd == "P" else serving_fwd
    if bwd == "P":
        ssd._launch_bwd = lambda x, Bm, Cm, dt, A, st, dy, dh, chunk: ssd_scan_bwd_ref(
            x, Bm, Cm, dt, A, st, dy, dh, chunk=chunk)
    try:
        yield
    finally:
        ssd._launch, ssd._launch_bwd = launch, launch_bwd


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_grads_split: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in (cs.SSM_ARCH, cs.HYBRID_ARCH):
        cfg = cs.get_config(arch)
        batch = SyntheticTokens(DataConfig(cfg.vocab_size, SEQ, BATCH)).batch_at(0)
        tokens = torch.from_numpy(batch["tokens"]).long().cuda()
        targets = torch.from_numpy(batch["targets"]).long().cuda()
        model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True).float()
        grads = {}
        for case in ("PP", "KK", "KP", "PK", "SP"):
            model.zero_grad(set_to_none=True)
            with scan_halves(case[0], case[1]), (
                    cs.plain_kernels() if case == "PP" else contextlib.nullcontext()):
                loss, _ = loss_fn(model, tokens, targets)
                loss.backward()
            grads[case] = {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}
        for case in ("KK", "KP", "PK", "SP"):
            errs = {n: float((g - grads["PP"][n]).norm() / grads["PP"][n].norm())
                    for n, g in grads[case].items()}
            worst = sorted(errs, key=errs.get)[-3:]
            print(json.dumps({"arch": arch, "case": case, "vs": "PP",
                              "worst_rel_norm_err": {n: errs[n] for n in worst}}),
                  flush=True)
        del model, grads
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
