"""Scale-out: a (dp, mp) grid of devices for batched rollouts and MPC.

Port of soft_robot_control_tpu/parallel/mesh.py, with its two axes:

- 'dp' (data parallel): independent closed loops / rollouts split along
  the batch, no communication;
- 'mp' (model parallel): the TPWL dictionary split along its points, each
  device of an mp row holding its part. A nearest-point select runs the
  TPWL select kernel index-only on every part, with the distance the
  kernel compared for the point it chose; the least distance wins, ties
  to the lowest part (the JAX package's pmin over the owner rank), and
  each selected row is copied once, from the part that owns it. Each
  distance depends on its state and point alone, so the index is the one
  the whole dictionary gives, bit for bit.

A mesh is a grid of torch devices driven by one controlling process,
which launches on every device in turn, as shard_map runs one program on
every device; there is no torch.distributed. A device may appear more
than once: one card, or the CPU, then runs every mesh shape, each part of
the dictionary a tensor of its own. The points split into contiguous parts
whose sizes differ by at most one, so no padding is needed.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from soft_robot_control_tpu_torch.models.tpwl import TPWLModel
from soft_robot_control_tpu_torch.ops.tpwl_select import tpwl_select
from soft_robot_control_tpu_torch.utils.device import as_tensor, resolve_device

TABLES = ("A_d", "B_d", "d_d")


class Mesh:
    """A (dp, mp) grid of torch devices: `devices[i, j]` serves batch part i
    and dictionary part j; `shape` reads as the JAX Mesh's."""

    def __init__(self, devices):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "mp": devices.shape[1]}


def make_mesh(dp: int, mp: int = 1, devices=None) -> Mesh:
    """The first dp*mp of `devices` (default: the visible CUDA devices) as a
    (dp, mp) grid, row by row. A device may be given more than once."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if dp * mp > len(devices):
        raise ValueError(f"need {dp * mp} devices, have {len(devices)}")
    arr = np.empty((dp, mp), dtype=object)
    for k in range(dp * mp):
        arr[k // mp, k % mp] = devices[k]
    return Mesh(arr)


class PointShards:
    """A TPWL dictionary's (q, v, A_d, B_d, d_d), and optional per-point
    gains, split along the points over a mesh's mp axis: part j holds the
    points offsets[j]..offsets[j+1]-1, as tensors of its own on each
    device of mesh column j."""

    def __init__(self, model: TPWLModel, mesh: Mesh, gains=None):
        mp = mesh.shape["mp"]
        P = model.num_points
        if P < mp:
            raise ValueError(f"{P} dictionary points cannot fill {mp} parts")
        sizes = [P // mp + (j < P % mp) for j in range(mp)]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])
        self._starts = {}  # the parts' first points, a tensor a device
        self.dist_w_q, self.dist_w_v = model.dist_w_q, model.dist_w_v
        tables = {"q": model.q, "v": model.v,
                  **{k: getattr(model, k) for k in TABLES}}
        if gains is not None:
            tables["K"] = gains
        self.parts = []
        for j in range(mp):
            lo, hi = self.offsets[j], self.offsets[j + 1]
            self.parts.append({dev: {k: a[lo:hi].to(dev, copy=True)
                                     for k, a in tables.items()}
                               for dev in set(mesh.devices[:, j])})

    def select(self, x, devices, index_only: int = 0, gains: bool = False):
        """Nearest-point (idx, A_d, B_d, d_d, K) for states x (B, n_x) on
        the parts held by `devices` (a mesh row), on x's device: every
        state's global index, the (A_d, B_d, d_d) rows of states
        index_only.., and with `gains` the gains of states ..index_only
        (else None). One index-only launch of the select kernel a part,
        one host read of the owners' counts, then each row copied from its
        owner."""
        home, Bsz, k = x.device, x.shape[0], int(index_only)
        dist, local = [], []
        for part, dev in zip(self.parts, devices):
            p = part[dev]
            i, _, _, _, d = tpwl_select(
                x.to(dev), p["q"], p["v"], p["A_d"], p["B_d"], p["d_d"],
                self.dist_w_q, self.dist_w_v, index_only=Bsz, distances=True)
            dist.append(d.to(home))
            local.append(i.to(home))
        owner = torch.argmin(torch.stack(dist), dim=0)  # ties: lowest part
        local = torch.stack(local).gather(0, owner[None])[0]
        if home not in self._starts:
            self._starts[home] = torch.as_tensor(self.offsets[:-1],
                                                 device=home)
        idx = local + self._starts[home][owner]
        mp = len(self.parts)
        groups = [(slice(k, Bsz), TABLES)]
        if gains:
            groups.append((slice(0, k), ("K",)))
        counts = torch.stack([torch.bincount(owner[s], minlength=mp)
                              for s, _ in groups]).tolist()
        out = {}
        for (s, names), cnt in zip(groups, counts):
            order = torch.argsort(owner[s], stable=True)
            loc = local[s]
            ref = self.parts[0][devices[0]]
            for name in names:
                out[name] = _rows_like(ref[name], len(order), home)
            c0 = 0
            for c, part, dev in zip(cnt, self.parts, devices):
                if c == 0:
                    continue
                rows = order[c0:c0 + c]
                li = loc[rows].to(dev)
                for name in names:
                    out[name].index_copy_(0, rows,
                                          part[dev][name][li].to(home))
                c0 += c
        return (idx, out["A_d"], out["B_d"], out["d_d"], out.get("K"))


def _rows_like(table, n: int, device):
    """An empty (n, ...) tensor on `device` whose rows are laid out in
    memory as the rows of `table` (a dense tensor) are, as `table[idx]`
    gives them: a product with a row then takes the same route, and
    rounds the same, as with the unsharded gather's rows (the DARE gains
    are stored transposed)."""
    dims = sorted(range(1, table.dim()), key=lambda d: -table.stride(d))
    rows = torch.empty((n,) + tuple(table.shape[d] for d in dims),
                       dtype=table.dtype, device=device)
    return rows.permute([0] + [1 + dims.index(d)
                               for d in range(1, table.dim())])


def shard_tpwl_gather(shards: PointShards, x, devices, index_only: int = 0):
    """The distributed nearest-point fetch: (idx, A_d, B_d, d_d) of the
    states x (B, n_x) over the dictionary parts of `shards` held by
    `devices` (a mesh row), rows for states index_only.. only."""
    return shards.select(x, devices, index_only)[:4]


def _batch_slices(B: int, mesh: Mesh):
    dp = mesh.shape["dp"]
    if B % dp:
        raise ValueError(f"batch {B} does not divide over dp={dp}")
    b = B // dp
    return [slice(i * b, (i + 1) * b) for i in range(dp)]


def sharded_rollout_batch(model: TPWLModel, x0, u, dt, mesh: Mesh):
    """Batched TPWL rollouts with the batch on 'dp' and the point dictionary
    on 'mp': x0 (B, n_x), u (B, N, n_u) -> (B, N+1, n_x) on the mesh's first
    device; B divides over dp. Each step of each batch part is one sharded
    select (`PointShards.select`) and the affine update."""
    if model.pre_discretized_dt != float(dt):
        model = model.pre_discretize(dt)
    shards = PointShards(model, mesh)
    dtype = model.q.dtype
    x0, u = as_tensor(x0, dtype), as_tensor(u, dtype)
    rows = _batch_slices(x0.shape[0], mesh)
    xs = [[x0[s].to(mesh.devices[i, 0])] for i, s in enumerate(rows)]
    us = [u[s].to(mesh.devices[i, 0]) for i, s in enumerate(rows)]
    for t in range(u.shape[1]):
        for i, traj in enumerate(xs):
            x = traj[-1]
            _, A, Bm, d, _ = shards.select(x, mesh.devices[i])
            traj.append(TPWLModel.update_dynamics(x, us[i][:, t], A, Bm, d))
    first = mesh.devices[0, 0]
    return torch.cat([torch.stack(traj, dim=1).to(first) for traj in xs])


def _on(obj, device):
    """A shallow copy of a BatchMPC (or one of its specs) with its tensors
    on `device`: its model, specs, tensors and tuples of tensors moved, its
    device attribute set. Tensors already there are shared."""
    new = copy.copy(obj)
    for k, a in vars(obj).items():
        if torch.is_tensor(a):
            a = a.to(device)
        elif isinstance(a, tuple) and a and all(map(torch.is_tensor, a)):
            a = tuple(t.to(device) for t in a)
        elif isinstance(a, torch.device):
            a = device
        elif isinstance(a, TPWLModel):
            a = a.to(device=device)
        elif k in ("spec", "cspec"):
            a = _on(a, device)
        setattr(new, k, a)
    return new


def _split_run(locals_, mesh: Mesh, mpc, n_windows: int, noise_std: float):
    """run(x_plant0, ekf_x0, z_target, noise=None, generator=None) over the
    dp rows: each row's loop (`locals_[i]`, a build_fused run) on its batch
    part, the measurement noise drawn once for the whole batch as the
    unsharded run draws it, the logs joined on the first device."""
    first = mesh.devices[0, 0]

    def run(x_plant0, ekf_x0, z_target, noise=None, generator=None):
        t = lambda a: as_tensor(a, mpc.dtype, first)
        x_p, x_e, z_target = t(x_plant0), t(ekf_x0), t(z_target)
        if noise_std > 0 and noise is None:
            noise = mpc._draw_noise(n_windows, x_p.shape[0], generator)
        logs = []
        for i, s in enumerate(_batch_slices(x_p.shape[0], mesh)):
            dev = mesh.devices[i, 0]
            nz = None if noise is None else noise[:, :, s].to(dev)
            logs.append(locals_[i](x_p[s].to(dev), x_e[s].to(dev),
                                   z_target[s].to(dev), nz))
        return {k: torch.cat([lg[k].to(first) for lg in logs])
                for k in logs[0]}

    return run


def sharded_batch_mpc_fused(mpc, n_windows: int, mesh: Mesh,
                            noise_std: float = 0.0, interpret=None):
    """The batch-fused closed loop (`BatchMPC.build_fused`) split over 'dp':
    a copy of the BatchMPC on the first device of each mesh row runs its
    part of the batch. No communication. `interpret` is the JAX package's
    argument and has no meaning here. Returns build_fused's run, with B
    divisible by dp."""
    locals_ = [_on(mpc, mesh.devices[i, 0]).build_fused(n_windows, noise_std)
               for i in range(mesh.shape["dp"])]
    return _split_run(locals_, mesh, mpc, n_windows, noise_std)


def sharded_batch_mpc_fused_mp(mpc, n_windows: int, mesh: Mesh,
                               noise_std: float = 0.0, interpret=None):
    """The batch-fused closed loop with the batch on 'dp' and the TPWL
    dictionary and its per-point DARE gains on 'mp': every nearest-point
    fetch of a window (the plan's relinearization, the plant step, the EKF
    prediction, the feedback gain) is a sharded select over the mesh row's
    parts (`PointShards.select`). The QPs solve once a row, on its first
    device. The rows' copies of the BatchMPC hold no dictionary tables of
    their own. Returns build_fused's run, with B divisible by dp; the
    indices, and so the logs, are those of the unsharded loop."""
    shards = PointShards(mpc.model, mesh, gains=mpc.K_pts)
    locals_ = []
    for i in range(mesh.shape["dp"]):
        local = _on(mpc, mesh.devices[i, 0])
        local.model = local.model._replace(
            **{k: None for k in TABLES + ("A_c", "B_c", "d_c")})
        local.K_pts = None
        local._mp = (shards, mesh.devices[i])
        locals_.append(local.build_fused(n_windows, noise_std))
    return _split_run(locals_, mesh, mpc, n_windows, noise_std)


def replicate(tree, mesh: Mesh):
    """Every tensor of a tree (tensors, lists, tuples, dicts) copied to each
    device of the mesh: a list with one tree a device, in the mesh's row
    order."""
    return [_map(tree, lambda a: a.to(dev)) for dev in mesh.devices.ravel()]


def shard_batch(tree, mesh: Mesh, axis: str = "dp"):
    """The leading axis of every tensor of a tree split over `axis`: a list
    with one tree a part, part i on the first device of mesh row i ('dp')
    or on device (0, i) ('mp')."""
    devs = mesh.devices[:, 0] if axis == "dp" else mesh.devices[0, :]
    n = len(devs)

    def part(i):
        def cut(a):
            if a.shape[0] % n:
                raise ValueError(f"leading axis {a.shape[0]} does not "
                                 f"divide over {axis}={n}")
            b = a.shape[0] // n
            return a[i * b:(i + 1) * b].to(devs[i])
        return _map(tree, cut)

    return [part(i) for i in range(n)]


def _map(tree, fn):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree
