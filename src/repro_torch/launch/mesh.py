"""Device meshes: a real one over this process's devices, and the dry run's
production meshes.

Twin of ``repro/launch/mesh.py``. Both are ``torch.distributed``
``DeviceMesh``es with the reference's axis names. A process group is global
state, so these are functions (nothing happens at import) and
``close_mesh`` ends the group; the tests open and close one in a fixture.

- ``make_local_mesh(data, model)``: a real mesh. One process is one rank:
  the group has world size 1 over an in-memory ``HashStore``, so no launcher
  and no environment variables are needed; ``nccl`` on the card, ``gloo``
  with ``device="cpu"``. A mesh of more than one device would need one
  process a device, so any data × model > 1 raises with the count of
  devices this process sees.
- ``make_production_mesh(multi_pod)``: the reference's 16×16 ("data",
  "model") or 2×16×16 ("pod", "data", "model") mesh of 256 or 512 ranks, for
  the dry run. No such machine is here: the group uses torch's ``"fake"``
  backend, which gives every rank's collectives an immediate, empty answer.
  It is the one in-process stand-in that lets DTensor, ``FlopCounterMode``
  and ``CommDebugMode`` see the production meshes, as
  ``--xla_force_host_platform_device_count=512`` does for the reference. It
  is a testing API (``torch.testing._internal.distributed.fake_pg``),
  imported inside ``make_production_mesh`` only and never on the serving or
  training path. The dry run computes this rank's program, on meta tensors.

The roofline's constants are one NVIDIA H100 SXM's, from NVIDIA's H100
Tensor Core GPU data sheet (dense rates, no sparsity, at the 700 W limit).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import resolve_device

# NVIDIA H100 SXM data sheet: bf16 tensor-core peak (dense)
PEAK_FLOPS_BF16 = 989e12
# f32-accurate products as three TF32 products (3×TF32) on the tensor cores:
# the data sheet's 495 TFLOP/s of TF32 (dense) over 3
PEAK_FLOPS_F32 = 495e12 / 3
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 SXM data sheet: NVLink 900 GB/s per GPU, both directions
# together; a collective's bytes leave a GPU in one direction: 450 GB/s
NVLINK_BW = 900e9 / 2

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _open_group(backend: str, world_size: int, store) -> None:
    """The default group, with this process as rank 0; an open group of the
    same backend and size is kept, a fake one of another size replaced, any
    other refused."""
    if dist.is_initialized():
        same = dist.get_backend() == backend and dist.get_world_size() == world_size
        if same:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of {dist.get_world_size()} "
                f"ranks is open; close it (close_mesh) before a {backend} mesh of "
                f"{world_size}")
        dist.destroy_process_group()
    dist.init_process_group(backend, store=store, rank=0, world_size=world_size)


def make_local_mesh(data: int = 1, model: int = 1, *, device: str | torch.device = "cuda"):
    """A real ("data", "model") mesh over this process's device."""
    dev = resolve_device(device)
    n = data * model
    if n > 1:
        seen = torch.cuda.device_count() if dev.type == "cuda" else 1
        raise ValueError(
            f"mesh data={data} × model={model} needs {n} devices, one process each; "
            f"this process sees {seen} {dev.type} device(s) and runs one rank, so "
            "the local mesh is 1 × 1")
    _open_group("nccl" if dev.type == "cuda" else "gloo", 1, dist.HashStore())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the fake backend (module docstring)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = PRODUCTION_SHAPES[multi_pod]
    size = 1
    for s in shape:
        size *= s
    _open_group("fake", size, FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def close_mesh() -> None:
    """End the process group a mesh opened (no-op when none is open)."""
    if dist.is_initialized():
        dist.destroy_process_group()
