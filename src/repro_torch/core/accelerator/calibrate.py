"""Calibrate the component cost library against the paper's Table I.

Run as a module to re-derive the constants baked into ``TimingModel`` /
``CostLibrary`` defaults:

    PYTHONPATH=src python -m repro_torch.core.accelerator.calibrate

Outputs the fitted constants and the per-row relative errors (reported in
EXPERIMENTS.md §Reproduction).  The paper's own TLM-vs-RTL fidelity budget is
~15% (Sec. II-D); rows exceeding it are flagged.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.accelerator import paper_data, paper_nets
from repro_torch.core.accelerator.arch import TimingModel
from repro_torch.core.accelerator.cycle_model import latency_cycles
from repro_torch.core.accelerator.resources import CostLibrary, estimate, accumulate_ops


def fit_timing(verbose: bool = True) -> tuple[TimingModel, dict[str, int], float]:
    """Grid-search global timing constants + per-net spike-train length T."""
    nets = list(paper_data.NETS)
    best = (None, None, np.inf)
    t_grid = {n: ([124] if n == "net-5" else range(15, 80)) for n in nets}
    for cpo, act, ret in itertools.product((1, 2, 3), (1, 2, 4, 6, 8),
                                           (0.7, 0.85, 1.0)):
        timing = TimingModel(acc_cycles_per_op=cpo, act_cycles=act,
                             pool_retention=ret)
        total_loss, t_pick = 0.0, {}
        for net in nets:
            rows = paper_data.tw_rows(net)
            losses = []
            for T in t_grid[net]:
                cfg0 = paper_nets.build(net, timing=timing, num_steps=T)
                counts = paper_nets.paper_counts(net, cfg0)
                loss = 0.0
                for r in rows:
                    pred = float(latency_cycles(cfg0.with_lhr(r.lhr), counts))
                    loss += abs(np.log(pred / r.cycles))
                losses.append((loss / len(rows), T))
            l, T = min(losses)
            total_loss += l
            t_pick[net] = T
        if total_loss < best[2]:
            best = (timing, t_pick, total_loss)
            if verbose:
                print(f"cpo={cpo} act={act} ret={ret} -> "
                      f"loss={total_loss/len(nets):.4f} T={t_pick}")
    timing, t_pick, loss = best
    return timing, t_pick, loss / len(nets)


def timing_residuals(timing: TimingModel, t_pick: dict[str, int]):
    rows_out = []
    for net in paper_data.NETS:
        cfg0 = paper_nets.build(net, timing=timing, num_steps=t_pick[net])
        counts = paper_nets.paper_counts(net, cfg0)
        for r in paper_data.tw_rows(net):
            pred = float(latency_cycles(cfg0.with_lhr(r.lhr), counts))
            rows_out.append((net, r.lhr, r.cycles, pred, pred / r.cycles - 1))
    return rows_out


def _irls(A: np.ndarray, y: np.ndarray, iters: int = 25) -> np.ndarray:
    """Robust (approx-L1) least squares — Table I contains outlier rows."""
    w = np.ones(len(y))
    sol = None
    for _ in range(iters):
        sol, *_ = np.linalg.lstsq(A * w[:, None], y * w, rcond=None)
        resid = np.abs(A @ sol - y) + 1e3
        w = 1.0 / np.sqrt(resid)
    return sol


def fit_resources() -> tuple[CostLibrary, list]:
    """Least-squares LUT/REG component costs over all TW rows.

    Conv NUs carry their own LUT coefficient: a conv Neural Unit holds the
    2D address-extraction datapath (paper Fig. 5) + per-position membrane
    access machinery, far costlier than the FC LIF ALU.
    """
    feats_lut, y_lut, feats_reg, y_reg, tags = [], [], [], [], []
    for net in paper_data.NETS:
        for r in paper_data.tw_rows(net):
            if r.lut is None:
                continue
            cfg = paper_nets.build(net, lhr=r.lhr)
            fc_nus = sum(l.num_nus for l in cfg.layers if l.kind == "fc")
            cv_nus = sum(l.num_nus for l in cfg.layers if l.kind == "conv")
            fan = sum(l.fan_in_size for l in cfg.layers)
            L = len(cfg.layers)
            feats_lut.append([fc_nus, cv_nus, L])
            y_lut.append(r.lut * 1e3)
            feats_reg.append([fc_nus, cv_nus, fan, L])
            y_reg.append(r.reg * 1e3)
            tags.append((net, r.lhr))
    lut_nu, lut_conv_nu, lut_layer = _irls(np.array(feats_lut, float),
                                           np.array(y_lut))
    reg_nu, reg_conv_nu, reg_addr, reg_layer = _irls(np.array(feats_reg, float),
                                                     np.array(y_reg))

    # split the per-NU LUT between NU datapath and memory mapping logic
    # (85/15 — the split is not observable from aggregate numbers) and the
    # per-layer LUT between the 100-bit PENC and the FSM/wrapper.
    lib = CostLibrary(
        lut_per_nu=round(0.85 * lut_nu, 1),
        lut_per_conv_nu=round(max(lut_conv_nu, 0.0), 1),
        lut_per_mem_block=round(0.15 * lut_nu, 1),
        lut_per_penc_bit=max(round((lut_layer * 0.45) / 100, 2), 0.0),
        lut_fixed_per_layer=round(lut_layer * 0.55, 1),
        reg_per_nu=round(reg_nu, 1),
        reg_per_conv_nu=round(max(reg_conv_nu, 0.0), 1),
        reg_per_addr_bit=round(reg_addr, 3),
        reg_fixed_per_layer=round(max(reg_layer, 0.0), 1),
    )
    resid_rows = []
    for (net, lhr), l_true, r_true in zip(tags, y_lut, y_reg):
        cfg = paper_nets.build(net, lhr=lhr)
        est = estimate(cfg, lib)
        resid_rows.append((net, lhr, l_true, est.lut, est.lut / l_true - 1,
                           r_true, est.reg, est.reg / r_true - 1))
    return lib, resid_rows


def fit_energy(lib: CostLibrary, timing: TimingModel,
               t_pick: dict[str, int]) -> CostLibrary:
    """Fit E = (a + b*LUT) * cycles/f + e_op * acc_ops  (non-negative LS)."""
    A, y = [], []
    for net in paper_data.NETS:
        cfg0 = paper_nets.build(net, timing=timing, num_steps=t_pick[net])
        counts = paper_nets.paper_counts(net, cfg0)
        for r in paper_data.tw_rows(net):
            if r.energy_mj is None:
                continue
            cfg = cfg0.with_lhr(r.lhr)
            runtime = r.cycles / (timing.clock_mhz * 1e6)   # use measured cycles
            lut = estimate(cfg, lib).lut
            ops = accumulate_ops(cfg, counts)
            A.append([runtime, lut * runtime, ops * 1e-12])
            y.append(r.energy_mj * 1e-3)
    A, y = np.array(A), np.array(y)
    # RELATIVE least squares (divide rows by y): Table I energies span
    # 0.09..20.5 mJ — absolute LS would fit only the DVS rows
    A = A / y[:, None]
    y = np.ones_like(y)
    # exact NNLS by active-set enumeration (3 vars -> 8 subsets)
    best_x, best_err = np.zeros(3), np.inf
    for mask in range(1, 8):
        idx = [i for i in range(3) if mask >> i & 1]
        sol, *_ = np.linalg.lstsq(A[:, idx], y, rcond=None)
        if (sol < 0).any():
            continue
        x = np.zeros(3)
        x[idx] = sol
        err = float(np.sum((A @ x - y) ** 2))
        if err < best_err:
            best_x, best_err = x, err
    a, b, e = best_x
    return dataclasses.replace(lib, static_w=round(float(a), 3),
                               w_per_lut=float(b), pj_per_acc_op=round(float(e), 1))


def main():
    print("== timing fit ==")
    timing, t_pick, loss = fit_timing()
    print(f"\nbest: {timing}  T={t_pick}  mean|log-err|={loss:.4f}\n")
    for net, lhr, actual, pred, err in timing_residuals(timing, t_pick):
        flag = "  <-- >15%" if abs(err) > 0.15 else ""
        print(f"{net} {str(lhr):>22}  actual={actual:>9.0f} pred={pred:>9.0f} "
              f"err={err:+.1%}{flag}")
    print("\n== resource fit ==")
    lib, rows = fit_resources()
    print(lib)
    for net, lhr, lt, lp, le, rt, rp, re in rows:
        print(f"{net} {str(lhr):>22}  LUT {lt/1e3:>6.1f}K->{lp/1e3:>6.1f}K "
              f"({le:+.0%})   REG {rt/1e3:>6.1f}K->{rp/1e3:>6.1f}K ({re:+.0%})")
    print("\n== energy fit ==")
    lib2 = fit_energy(lib, timing, t_pick)
    print(f"static_w={lib2.static_w} w_per_lut={lib2.w_per_lut:.3e} "
          f"pj_per_acc_op={lib2.pj_per_acc_op}")


if __name__ == "__main__":
    main()
