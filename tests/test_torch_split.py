"""Which reads of a batch the port's engine gives the host search, on the
CPU: the arena and step budget by device type, genome and budget
(`engine.caps` / `make_config`), the first host share by device type
(`engine.first_host_share`, IBWA_HOST_FRAC fixing it), and the
controller's balance between batches (`TorchAlnEngine._balance`) with
the pool's spans given by hand.  No table and no card: the rules alone."""

import numpy as np
import pytest

from ibwa_tpu_torch.align import engine
from ibwa_tpu_torch.align.opts import BWA_MODE_NONSTOP, GapOpt

BIG, SMALL = 1 << 28, 1 << 20   # a chr1-sized genome; one below 2^22
GAPPY = GapOpt(max_gapo=2, max_gape=5, max_diff=6, fnr=-1.0)
NONSTOP = GapOpt(mode=GapOpt().mode | BWA_MODE_NONSTOP)


@pytest.mark.parametrize("opt,max_diff,seq_len,cpu_acap,card", [
    (GapOpt(), 5, BIG, 256, (2048, 1536)),    # the benchmark cells' reads
    (GapOpt(), 5, SMALL, 1024, (1024, 384)),  # wide SA intervals
    (GAPPY, 6, BIG, 1024, (1024, 1536)),      # a wide budget
    (GAPPY, 6, SMALL, 1024, (1024, 384)),
    (NONSTOP, 5, BIG, 1024, (1024, 384)),
], ids=["narrow_big", "narrow_small", "gappy", "gappy_small", "nonstop"])
def test_caps_by_device_and_genome(opt, max_diff, seq_len, cpu_acap, card):
    """The CPU keeps engine_jax's caps; a card raises both on a narrow
    budget over a big genome, the step budget alone on a wide budget, and
    neither under -N or below 2^22, in `make_config`'s config as in
    `caps`."""
    assert engine.caps(max_diff, opt, seq_len) == (cpu_acap, engine.ITER_CAP)
    assert engine.caps(max_diff, opt, seq_len, "cuda") == card
    for device_type, (acap, cap) in (("cpu", (cpu_acap, engine.ITER_CAP)),
                                     ("cuda", card)):
        cfg = engine.make_config(104, max_diff, opt, seq_len=seq_len,
                                 device_type=device_type)
        assert (cfg.acap, cfg.iter_cap) == (acap, cap), device_type


def test_card_caps_are_the_chosen_ones():
    """A card's chr1-sized genome under the default options gets the
    sweep's setting, above the CPU's on both caps; `batch_config` passes
    the device type on."""
    assert engine.caps(5, GapOpt(), BIG, "cuda") == (2048, 1536)
    seqs = [np.zeros(100, np.uint8)] * 3
    cpu, _, _ = engine.batch_config(seqs, GapOpt(), BIG)
    card, _, _ = engine.batch_config(seqs, GapOpt(), BIG, "cuda")
    assert (cpu.acap, cpu.iter_cap) == (256, 384)
    assert (card.acap, card.iter_cap) == (2048, 1536)


def test_patched_cpu_caps_keep_their_meaning(monkeypatch):
    """Tests that patch ITER_CAP / ACAP set the CPU's caps; a card's move
    with CARD_ITER_CAP / CARD_ACAP."""
    monkeypatch.setattr(engine, "ITER_CAP", 24)
    monkeypatch.setattr(engine, "ACAP", 1024)
    assert engine.caps(5, GapOpt(), BIG) == (1024, 24)
    monkeypatch.setattr(engine, "CARD_ITER_CAP", 6144)
    monkeypatch.setattr(engine, "CARD_ACAP", 256)
    assert engine.caps(5, GapOpt(), BIG, "cuda") == (1024, 6144)


@pytest.mark.parametrize("env", [None, "1.0", "0"], ids=["unset", "1", "0"])
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_first_host_share_by_device(device_type, env, monkeypatch):
    """A card starts at CARD_HOST_FRAC_INIT, the CPU at HOST_FRAC_INIT
    (0.30, the TPU's ratio); IBWA_HOST_FRAC wins on both."""
    if env is None:
        monkeypatch.delenv("IBWA_HOST_FRAC", raising=False)
        want = {"cpu": 0.30, "cuda": engine.CARD_HOST_FRAC_INIT}[device_type]
    else:
        monkeypatch.setenv("IBWA_HOST_FRAC", env)
        want = float(env)
    assert engine.first_host_share(device_type) == want
    assert engine.HOST_FRAC_INIT == 0.30


class _Spans:
    """The two pool spans' totals of batch 0, given by hand."""

    def __init__(self, host_s: float, fallback_s: float):
        self.t = {"aln.host_search": host_s,
                  "aln.fallback_search": fallback_s}

    def total(self, name, batch=None):
        return self.t.get(name, 0.0) if batch == 0 else 0.0


def _balanced(share, host_s, fallback_s, n_host, n_fb, fixed=False,
              n_reads=10_000, t_dev=1.0):
    eng = engine.TorchAlnEngine.__new__(engine.TorchAlnEngine)
    eng.spans, eng.host_frac, eng._frac_fixed = (_Spans(host_s, fallback_s),
                                                 share, fixed)
    eng._balance(0, n_reads, n_host, n_fb, n_reads - n_host, t_dev)
    return eng.host_frac


@pytest.mark.parametrize("host_s,fallback_s,n_host,n_fb,want", [
    # no host share: the overflow's rate alone; 0.5 s for 2,000 reads
    # leaves room for 2,000 more in the 1 s wall: f* 0.2
    (0.0, 0.5, 0, 2000, 0.5 * 0.1 + 0.5 * 0.2),
    # the overflow fills the wall twice over: down to no share
    (0.0, 2.0, 0, 2000, 0.5 * 0.1),
    # both kinds of job over both kinds of read: 2 s for 4,000 reads, the
    # wall holds 2,000, all overflow: no share (the host share's time
    # alone, 0.5 s, would have asked for 0.6)
    (0.5, 1.5, 2000, 2000, 0.5 * 0.1),
    # an idle pool raises the share, to at most 0.85
    (0.1, 0.0, 1000, 0, 0.5 * 0.1 + 0.5 * 0.85),
], ids=["overflow_only", "overflow_fills", "both_kinds", "idle_pool"])
def test_balance_counts_the_overflow_time(host_s, fallback_s, n_host, n_fb,
                                          want):
    assert _balanced(0.1, host_s, fallback_s, n_host, n_fb) == \
        pytest.approx(want, abs=1e-12)


def test_balance_leaves_a_fixed_or_unmeasured_share():
    """A fixed share does not move; nor does one with no pool time to
    measure (a card at no share whose batch did not overflow stays at 0
    however long the devices' wall), or with no card reads."""
    assert _balanced(0.3, 0.5, 1.0, 3000, 2000, fixed=True) == 0.3
    assert _balanced(0.0, 0.0, 0.0, 0, 0, t_dev=10.0) == 0.0
    assert _balanced(0.3, 0.5, 0.0, 10_000, 0) == 0.3   # all on the host

