"""3D geometry: vectors, quaternions, rigid transforms, on tensors.

The reference's vendored STLIB numerics (dependencies/numerics/{vec3,
quat,matrix,__init__}.py: Vec3, Quat, Matrix and TRS_to_matrix), as the
JAX package redesigns them: stateless functions over any leading batch
axes instead of mutable containers. They compute on the device and in the
dtype of their tensor inputs; inputs given as numbers or lists become
float64 tensors there, or, where no input is a tensor, on `device` (the
card unless the caller asks for the CPU).

Quaternion convention: [x, y, z, w] (scalar last), as SOFA and splib.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from soft_robot_control_tpu_torch.utils.device import resolve_device


def _like(a, ref=None, device=None):
    """a as a tensor: as it is if it is one; else float64 (or ref's
    floating dtype) on ref's device, or on `device`."""
    if torch.is_tensor(a):
        return a
    if ref is not None:
        dtype = ref.dtype if ref.is_floating_point() else torch.float64
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=ref.device)
    return torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                           device=resolve_device(device or "cuda"))


def _first_tensor(*args):
    return next((a for a in args if torch.is_tensor(a)), None)

# ----------------------------------------------------------------- vectors


def vnorm(v):
    return torch.linalg.norm(_like(v), dim=-1)


def vnormalize(v, eps=1e-12):
    v = _like(v)
    return v / (vnorm(v)[..., None] + eps)


def vdot(a, b):
    return torch.sum(a * b, dim=-1)


def vcross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def vrotate_axis_angle(v, axis, angle):
    """Rodrigues rotation of v about `axis` by `angle` (radians)."""
    k = vnormalize(_like(axis, v))
    angle = _like(angle, v)
    c, s = torch.cos(angle), torch.sin(angle)
    return v * c + vcross(k, v) * s + k * vdot(k, v)[..., None] * (1 - c)


# -------------------------------------------------------------- quaternions


def quat_identity(dtype=float, device="cuda"):
    dt = torch.float64 if dtype is float else dtype
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt,
                        device=resolve_device(device))


def quat_from_axis_angle(axis, angle, device=None):
    ref = _first_tensor(axis, angle)
    k = vnormalize(_like(axis, ref, device))
    half = _like(angle, k) / 2.0
    return torch.cat([k * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def quat_mul(q1, q2):
    """Hamilton product, [x,y,z,w] convention."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conjugate(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q, eps=1e-12):
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q."""
    qv = torch.cat([v, torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype,
                                   device=v.device)], dim=-1)
    return quat_mul(quat_mul(q, qv), quat_conjugate(q))[..., :3]


def quat_to_matrix(q):
    """3x3 rotation matrix from a unit quaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_from_euler(rx, ry, rz, degrees=False, device=None):
    """Intrinsic XYZ Euler angles to quaternion."""
    ref = _first_tensor(rx, ry, rz)
    rx, ry, rz = (_like(a, ref, device) for a in (rx, ry, rz))
    if degrees:
        rx, ry, rz = (a * (math.pi / 180.0) for a in (rx, ry, rz))
    axes = torch.eye(3, dtype=rx.dtype, device=rx.device)
    qx, qy, qz = (quat_from_axis_angle(axes[i], a)
                  for i, a in enumerate((rx, ry, rz)))
    return quat_mul(qx, quat_mul(qy, qz))


# ------------------------------------------------------------- transforms


def trs_to_matrix(translation, rotation_euler_deg=None, scale=None,
                  quaternion=None, device=None):
    """4x4 homogeneous transform from Translation/Rotation/Scale, the
    TRS_to_matrix capability (dependencies/numerics/__init__.py:36-80)."""
    ref = _first_tensor(translation, rotation_euler_deg, scale, quaternion)
    t = _like(translation, ref, device)
    if quaternion is not None:
        R = quat_to_matrix(quat_normalize(_like(quaternion, t)))
    elif rotation_euler_deg is not None:
        r = _like(rotation_euler_deg, t)
        R = quat_to_matrix(quat_from_euler(r[0], r[1], r[2], degrees=True))
    else:
        R = torch.eye(3, dtype=t.dtype, device=t.device)
    s = (torch.ones(3, dtype=t.dtype, device=t.device) if scale is None
         else _like(scale, t))
    M = torch.zeros((4, 4), dtype=t.dtype, device=t.device)
    M[:3, :3] = R * s[None, :]
    M[:3, 3] = t
    M[3, 3] = 1.0
    return M


def transform_points(M, pts):
    """Apply a 4x4 transform to (..., 3) points."""
    pts = _like(pts, M)
    return pts @ M[:3, :3].T + M[:3, 3]
