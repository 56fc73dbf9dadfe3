"""Hand-object penetration loss.

Port of `uvhand_tpu/losses/penetration.py` (the reference's
`compute_penetration_loss` / `penetration_loss` / `get_NN`,
arctic_tools/src/utils/loss_modules.py): object vertices whose nearest hand
vertex's outward normal points toward them are "interior"; their squared
nearest-neighbour distances are summed, times 120 / B. The vertex normals are
a scatter-add of the face normals (`index_add_` where the JAX package uses
`.at[].add`); the nearest neighbour is the first argmin of one distance
matrix, as `jnp.argmin`. Defined but unweighted in the reference's training
config.
"""

from __future__ import annotations

import torch


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals. verts (B, V, 3), faces (F, 3) int."""
    faces = torch.as_tensor(faces, device=verts.device).long()
    v0, v1, v2 = (verts[:, faces[:, k]] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)  # (B, F, 3), area-weighted
    n = torch.zeros_like(verts)
    for k in range(3):
        n = n.index_add(1, faces[:, k], fn)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)


def nearest_hand_for_object(obj_v: torch.Tensor, hand_v: torch.Tensor):
    """get_NN: the nearest hand vertex (squared distance, index) of every
    object vertex."""
    d2 = ((obj_v ** 2).sum(-1)[:, :, None] + (hand_v ** 2).sum(-1)[:, None, :]
          - 2 * torch.einsum("bnc,bmc->bnm", obj_v, hand_v))
    idx = torch.argmin(d2, -1)  # the first minimum, as jnp.argmin
    dist = torch.gather(d2, -1, idx[..., None])[..., 0]
    return dist.clamp(min=0.0), idx.to(torch.int32)


def penetration_loss(hand_faces, hand_v: torch.Tensor, obj_v: torch.Tensor,
                     obj_mask: torch.Tensor, is_valid: torch.Tensor,
                     hand_valid: torch.Tensor) -> torch.Tensor:
    """hand_faces (F, 3); hand_v (B, 778, 3) and obj_v (B, Vo, 3) in camera
    space (obj_v padded, `obj_mask` 1 on real vertices); is_valid and
    hand_valid (B,)."""
    nn_dist, nn_idx = nearest_hand_for_object(obj_v, hand_v)
    normals = vertex_normals(hand_v, hand_faces)
    idx = nn_idx.long()[..., None].expand(-1, -1, 3)
    nn_xyz = torch.gather(hand_v, 1, idx)
    nn_normal = torch.gather(normals, 1, idx)
    interior = ((nn_xyz - obj_v) * nn_normal).sum(-1) > 0
    valid = (hand_valid * is_valid)[:, None] > 0
    interior = interior & valid & (obj_mask > 0)
    return 120.0 * (nn_dist * interior).sum() / hand_v.shape[0]
