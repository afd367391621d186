"""The nine g2o robust kernels as IRLS weight functions
(port of hdl_graph_slam_tpu/graph/robust.py).

GraphSLAM::add_robust_kernel (src/hdl_graph_slam/graph_slam.cpp:275-290)
builds kernels by name; robust_kernel_io.cpp:14-43 lists the set. Each maps
the edge's chi2 e2 to (rho0, rho1): the robustified chi2 and the weight that
scales the edge's H and b (g2o's first-order robustification). Every edge
carries an int kernel id and a delta; all ten formulas are evaluated and the
id picks one, as in the JAX package.
"""

from __future__ import annotations

import torch

KERNEL_IDS = {
    "NONE": 0,
    "Huber": 1,
    "Cauchy": 2,
    "DCS": 3,
    "Fair": 4,
    "GemanMcClure": 5,
    "PseudoHuber": 6,
    "Saturated": 7,
    "Tukey": 8,
    "Welsch": 9,
}
KERNEL_NAMES = {v: k for k, v in KERNEL_IDS.items()}


def rho_and_weight(e2: torch.Tensor, kernel_id: torch.Tensor, delta: torch.Tensor):
    """(rho0, rho1) for each edge; formulas of g2o's robust_kernel_impl.cpp."""
    e2 = torch.clamp(e2, min=0.0)
    d = delta
    d2 = d * d
    e = torch.sqrt(e2 + 1e-30)

    hub_out = e2 > d2
    rho0_h = torch.where(hub_out, 2.0 * e * d - d2, e2)
    rho1_h = torch.where(hub_out, d / e, torch.ones_like(e2))
    c_aux = 1.0 + e2 / d2
    rho0_c = d2 * torch.log(c_aux)
    rho1_c = 1.0 / c_aux
    s_dcs = torch.clamp(2.0 * d / (d + e2), max=1.0)
    rho0_dcs = s_dcs * (2.0 - s_dcs) * e2
    rho1_dcs = s_dcs * s_dcs
    f_aux = e / d
    rho0_f = 2.0 * d2 * (f_aux - torch.log1p(f_aux))
    rho1_f = 1.0 / (1.0 + f_aux)
    gm_aux = d / (d + e2)
    rho0_gm = e2 * gm_aux
    rho1_gm = gm_aux * gm_aux
    ph_aux = torch.sqrt(1.0 + e2 / d2)
    rho0_ph = 2.0 * d2 * (ph_aux - 1.0)
    rho1_ph = 1.0 / ph_aux
    rho0_s = torch.minimum(e2, d2)
    rho1_s = (e2 <= d2).to(e2.dtype)
    t_in = e2 <= d2
    t_aux = torch.clamp(1.0 - e2 / d2, min=0.0)
    rho0_t = torch.where(t_in, d2 / 3.0 * (1.0 - t_aux**3), d2 / 3.0)
    rho1_t = torch.where(t_in, t_aux * t_aux, torch.zeros_like(e2))
    w_aux = torch.exp(-e2 / d2)
    rho0_w = d2 * (1.0 - w_aux)
    rho1_w = w_aux

    rho0_all = torch.stack([e2, rho0_h, rho0_c, rho0_dcs, rho0_f, rho0_gm, rho0_ph, rho0_s, rho0_t, rho0_w], dim=-1)
    rho1_all = torch.stack(
        [torch.ones_like(e2), rho1_h, rho1_c, rho1_dcs, rho1_f, rho1_gm, rho1_ph, rho1_s, rho1_t, rho1_w], dim=-1
    )
    kid = torch.clamp(kernel_id.long(), 0, 9)[..., None]
    return torch.gather(rho0_all, -1, kid)[..., 0], torch.gather(rho1_all, -1, kid)[..., 0]
