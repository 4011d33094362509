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
attention (hymba) runs its kernels except in PP. With ``--parent DIR`` (the
root of an unpacked older tree) the older tree's training kernels are a
candidate arithmetic too: OO runs its forward and backward, OK its forward
with this tree's backward, KO the other way round, each held against PP
beside KK, so one run compares two arithmetics of the scan's products (here
PR 20's f32 FMAs on the CUDA cores against the FP64 tensor cores) at full
width. Prints the three worst parameters of each case, and the card's name
and power limit::

    python tools/ssd_grads_split.py [--parent build/parent]
"""

from __future__ import annotations

import argparse
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


def older_kernels(libs: dict):
    """(training forward, backward) with ``ssd._launch``'s and
    ``ssd._launch_bwd``'s signatures from another tree's libraries
    (``tools/ssd_bwd_ab.build``'s entry)."""
    launch = ssd._launch

    def fwd(x, Bm, Cm, dt, A, chunk, return_state, with_states=False):
        if not with_states:
            return launch(x, Bm, Cm, dt, A, chunk, return_state)
        B, L, H, P = x.shape
        N = Bm.shape[-1]
        y, h = torch.empty_like(x), torch.empty(B, H, N, P, device=x.device)
        states = torch.empty(B, L // chunk, H, N, P, device=x.device)
        cb = torch.empty(B * (L // chunk) * chunk * chunk, device=x.device)
        rc = libs["fwd"](x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                         A.data_ptr(), y.data_ptr(), h.data_ptr(), cb.data_ptr(),
                         states.data_ptr(), B, L, H, P, N, chunk,
                         torch.cuda.current_stream().cuda_stream)
        ssd._build.check(rc, "older ssd_scan_fwd_states")
        return y, h, states

    def bwd(x, Bm, Cm, dt, A, states, dy, dh, chunk):
        B, L, H, P = x.shape
        N = Bm.shape[-1]
        grads = tuple(torch.empty_like(t) for t in (x, Bm, Cm, dt, A))
        scratch = torch.empty(libs["scratch"](B, L, H, P, N, chunk), device=x.device)
        rc = libs["bwd"](x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                         A.data_ptr(), states.data_ptr(), dy.data_ptr(),
                         None if dh is None else dh.data_ptr(),
                         *(g.data_ptr() for g in grads), scratch.data_ptr(), B, L, H, P, N,
                         chunk, torch.cuda.current_stream().cuda_stream)
        ssd._build.check(rc, "older ssd_scan_bwd")
        return grads

    return fwd, bwd


@contextlib.contextmanager
def scan_halves(fwd: str, bwd: str, older=None):
    """The scan's forward ("K" kernel, "P" plain, "S" serving's kernel, "O"
    the older tree's kernel) and backward ("K", "P" or "O") within the block."""
    launch, launch_bwd = ssd._launch, ssd._launch_bwd

    def plain_fwd(x, Bm, Cm, dt, A, chunk, return_state, with_states=False):
        return ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk, return_states=with_states,
                           cs64=with_states)

    def serving_fwd(x, Bm, Cm, dt, A, chunk, return_state, with_states=False):
        y, h = launch(x, Bm, Cm, dt, A, chunk, True)
        return (y, h, launch(x, Bm, Cm, dt, A, chunk, True, with_states=True)[2]) \
            if with_states else (y, h)

    if fwd != "K":
        ssd._launch = {"P": plain_fwd, "S": serving_fwd, "O": older and older[0]}[fwd]
    if bwd == "O":
        ssd._launch_bwd = older[1]
    if bwd == "P":
        ssd._launch_bwd = lambda x, Bm, Cm, dt, A, st, dy, dh, chunk: ssd_scan_bwd_ref(
            x, Bm, Cm, dt, A, st, dy, dh, chunk=chunk)
    try:
        yield
    finally:
        ssd._launch, ssd._launch_bwd = launch, launch_bwd


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an older tree whose training kernels are a candidate")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssd_grads_split: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    older = None
    cases = ["KK", "KP", "PK", "SP"]
    if args.parent is not None:
        sys.path.insert(0, str(ROOT / "tools"))
        import ssd_bwd_ab
        older = older_kernels(ssd_bwd_ab.build({"parent": args.parent})["parent"])
        cases += ["OO", "OK", "KO"]
    for arch in (cs.SSM_ARCH, cs.HYBRID_ARCH):
        cfg = cs.get_config(arch)
        batch = SyntheticTokens(DataConfig(cfg.vocab_size, SEQ, BATCH)).batch_at(0)
        tokens = torch.from_numpy(batch["tokens"]).long().cuda()
        targets = torch.from_numpy(batch["targets"]).long().cuda()
        model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True).float()
        grads = {}
        for case in ["PP"] + cases:
            model.zero_grad(set_to_none=True)
            with scan_halves(case[0], case[1], older), (
                    cs.plain_kernels() if case == "PP" else contextlib.nullcontext()):
                loss, _ = loss_fn(model, tokens, targets)
                loss.backward()
            grads[case] = {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}
        for case in cases:
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
