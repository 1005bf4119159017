"""The port's copies of the paper's reproductions
(repro_torch.core.accelerator.paper_data, paper_nets, calibrate) against
the JAX package's, field by field, and the reference's Table I claims
through the port's copies.

Both sides are NumPy on the same inputs, so every comparison is exact.
``calibrate.fit_timing`` (a grid search of about half a minute) is not run
here; its output is compared by running both packages' ``calibrate``
mains.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.accelerator import calibrate as jcalibrate
from repro.core.accelerator import paper_data as jpaper_data
from repro.core.accelerator import paper_nets as jpaper_nets
from repro_torch.core.accelerator import (arch, calibrate, cycle_model,
                                          paper_data, paper_nets, resources)

NETS = list(paper_data.NETS)


def _asdict(x):
    return dataclasses.asdict(x)


def test_nets_equal():
    assert NETS == list(jpaper_data.NETS) and len(NETS) == 5
    for net in NETS:
        assert _asdict(paper_data.NETS[net]) == _asdict(jpaper_data.NETS[net])


@pytest.mark.parametrize("net", NETS)
def test_table_rows_equal(net):
    assert ([_asdict(r) for r in paper_data.tw_rows(net)]
            == [_asdict(r) for r in jpaper_data.tw_rows(net)])
    assert paper_data.tw_rows(net)
    assert (_asdict(paper_data.baseline_row(net))
            == _asdict(jpaper_data.baseline_row(net)))


@pytest.mark.parametrize("net", NETS)
def test_paper_nets_equal(net):
    assert paper_nets.DEFAULT_T == jpaper_nets.DEFAULT_T
    assert (paper_nets.pool_before_flags(net)
            == jpaper_nets.pool_before_flags(net))
    lhrs = [None] + [r.lhr for r in paper_data.tw_rows(net)]
    for lhr in lhrs:
        cfg = paper_nets.build(net, lhr=lhr)
        jcfg = jpaper_nets.build(net, lhr=lhr)
        assert _asdict(cfg) == _asdict(jcfg)
        counts = paper_nets.paper_counts(net, cfg)
        jcounts = jpaper_nets.paper_counts(net, jcfg)
        assert len(counts) == len(jcounts) == len(cfg.layers)
        for c, j in zip(counts, jcounts):
            np.testing.assert_array_equal(c, j)


def test_timing_residuals_equal():
    rows = calibrate.timing_residuals(arch.TimingModel(),
                                      paper_nets.DEFAULT_T)
    jrows = jcalibrate.timing_residuals(jcalibrate.TimingModel(),
                                        jpaper_nets.DEFAULT_T)
    assert len(rows) == len(jrows) > 0
    assert rows == jrows


@pytest.mark.parametrize("seed", [0, 1])
def test_irls_equal(seed):
    rng = np.random.default_rng(seed)
    A = rng.random((20, 3)) * 100
    y = A @ np.array([3.0, 1.5, 40.0]) + rng.standard_normal(20) * 5
    y[3] += 5e3                                        # an outlier row
    np.testing.assert_array_equal(calibrate._irls(A, y),
                                  jcalibrate._irls(A, y))


def test_fit_resources_and_energy_equal():
    lib, rows = calibrate.fit_resources()
    jlib, jrows = jcalibrate.fit_resources()
    assert _asdict(lib) == _asdict(jlib)
    assert rows == jrows
    timing = arch.TimingModel()
    e = calibrate.fit_energy(lib, timing, paper_nets.DEFAULT_T)
    je = jcalibrate.fit_energy(jlib, jcalibrate.TimingModel(),
                               jpaper_nets.DEFAULT_T)
    assert _asdict(e) == _asdict(je)


class TestTable1ThroughThePort:
    """tests/test_accelerator.py's reproduction claims, on the copies."""

    def test_latency_median_error_under_15pct(self):
        errs = []
        for net in NETS:
            cfg0 = paper_nets.build(net)
            counts = paper_nets.paper_counts(net, cfg0)
            for r in paper_data.tw_rows(net):
                pred = float(cycle_model.latency_cycles(cfg0.with_lhr(r.lhr),
                                                        counts))
                errs.append(abs(pred / r.cycles - 1))
        assert np.median(errs) < 0.15

    def test_lut_median_error_under_10pct(self):
        errs = []
        for net in NETS:
            for r in paper_data.tw_rows(net):
                if r.lut is None:
                    continue
                est = resources.estimate(paper_nets.build(net, lhr=r.lhr))
                errs.append(abs(est.lut / (r.lut * 1e3) - 1))
        assert np.median(errs) < 0.10

    def test_net1_lhr_488_saves_70_to_85pct_of_luts(self):
        base = resources.estimate(paper_nets.build("net-1", lhr=(1, 1, 1)))
        opt = resources.estimate(paper_nets.build("net-1", lhr=(4, 8, 8)))
        assert 0.70 < 1 - opt.lut / base.lut < 0.85
