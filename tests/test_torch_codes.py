"""The compact step's fixpoint with its codes, and general_prep, on the CPU.

intra_batch_fixpoint (conflict/fused.py), given codes_out, scal and
too_old, also writes the verdict codes and returns the insert mask: on the
card the codes are the last phase of the fixpoint's own launch.  Its
plain version is held against the reference's block
(foundationdb_tpu/conflict/fused.py:373-405, written out below with jnp:
the fixpoint's lax.while_loop with its rounds counted, then the survivors,
the insert mask and the codes).  general_prep (one launch on the card,
ig_prep) is held against fused.py:479-511, the general step's too-old,
live reads, history bits scattered per txn and the writers' eligibility.

The cases: n_t and n_w at 0 and at the pads, t_cap 1, reads and writes
of txn -1 (which read txn 0's flags and scatter onto t_cap - 1), too-old
txns that have writes, txns with writes and no reads (t_has_reads 0),
snapshots equal to the window floor (not too old), every txn conflicted,
t_cap above and below w_pad, and a chain of intra-batch conflicts.

The cases are built without JAX (the cuda tests in test_torch_kernels.py
reuse them); JAX is imported inside the reference functions.  Integer
data: tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import fused

CODES_CASES = ["mixed", "n_zero", "n_full", "t_cap_1", "txn_minus_1",
               "too_old_writers", "all_conflicted", "t_cap_gt_w_pad",
               "t_cap_lt_w_pad", "chain"]
GPREP_CASES = ["mixed", "n_zero", "n_full", "t_cap_1", "txn_minus_1",
               "too_old_writers", "writes_no_reads", "snap_eq_oldest",
               "all_conflicted"]
FIX_INPUTS = ("hist", "r_txn", "r_live", "r_slot", "w_txn", "w_ok",
              "w_slot")
OLDEST = 1000


def _txns(rng, n: int, pad: int, lo: int, hi: int) -> np.ndarray:
    """`n` sorted txn ids in [lo, hi), then `pad - n` padding ids."""
    txn = np.full(pad, max(hi, 1), np.int32)
    txn[:n] = np.sort(rng.integers(lo, max(hi, lo + 1), size=n))
    return txn


def codes_case(name: str, seed: int = 0, t_cap: int = 64, r_pad: int = 203,
               w_pad: int = 101, u_pad: int = 37) -> dict:
    """The fixpoint's inputs (int32 numpy: hist, r_txn, r_live, r_slot,
    w_txn, w_ok, w_slot as read_write_prep gives them), too_old and the
    compact scalars for one named case, shapes under "shape": (t_cap,
    r_pad, w_pad, u_pad).  Reads and writes of live txns are sorted by
    txn, as the rank counts give them; past n_r / n_w they are dead."""
    shape = {"t_cap_1": (1, 9, 5, 3), "t_cap_gt_w_pad": (300, 203, 37, 37),
             "t_cap_lt_w_pad": (16, 203, 101, 37)}.get(
                 name, (t_cap, r_pad, w_pad, u_pad))
    t_cap, r_pad, w_pad, u_pad = shape
    rng = np.random.default_rng(seed + 7 * CODES_CASES.index(name))
    n_t = {"n_zero": 0, "n_full": t_cap, "t_cap_1": 1}.get(
        name, max(t_cap - 5, 1))
    n_r = {"n_zero": 0, "n_full": r_pad}.get(name, r_pad - 7)
    n_w = {"n_zero": 0, "n_full": w_pad}.get(name, w_pad - 3)
    old_share = 0.5 if name == "too_old_writers" else 0.15
    too_old = ((np.arange(t_cap) < n_t)
               & (rng.random(t_cap) < old_share)).astype(np.int32)
    lo = -1 if name != "n_zero" else 0
    r_txn = _txns(rng, n_r, r_pad, lo, n_t)
    w_txn = _txns(rng, n_w, w_pad, lo, n_t)
    if name == "txn_minus_1":
        r_txn[:n_r // 4] = -1
        w_txn[:n_w // 4] = -1
    elif n_r and lo < 0:
        r_txn[:min(3, n_r)] = -1
        w_txn[:min(2, n_w)] = -1
    # Slot u_pad - 1 is written only by txn -1 and read by none: a txn -1
    # write takes txn 0's flags, so covering a key txn 0 reads would make
    # txn 0's verdict flip every round (the reference's while_loop, as the
    # plain version, would never end; the compact step never builds it).
    r_slot = rng.integers(0, u_pad - 1, size=r_pad).astype(np.int32)
    w_slot = rng.integers(0, u_pad - 1, size=w_pad).astype(np.int32)
    if name == "chain":           # txn i reads the key txn i - 1 writes
        depth = min(20, n_r, n_w, n_t)
        r_txn[:depth] = w_txn[:depth] = np.arange(depth)
        r_slot[:depth] = np.arange(depth) + u_pad - depth - 1
        w_slot[:depth] = np.arange(depth) + u_pad - depth
        r_slot[depth:n_r] %= u_pad - depth - 1
        w_slot[depth:n_w] %= u_pad - depth - 1
        r_txn[depth:n_r] = np.maximum(r_txn[depth:n_r], depth)
        w_txn[depth:n_w] = np.maximum(w_txn[depth:n_w], depth)
        too_old[:depth] = 0
    w_slot[w_txn == -1] = u_pad - 1
    clamp = lambda x: np.clip(x, 0, t_cap - 1)
    r_live = ((np.arange(r_pad) < n_r)
              & (too_old[clamp(r_txn)] == 0)).astype(np.int32)
    w_ok = ((np.arange(w_pad) < n_w)
            & (too_old[clamp(w_txn)] == 0)).astype(np.int32)
    hist = (rng.random(t_cap) < 0.1).astype(np.int32)
    if name == "all_conflicted":
        hist[:] = 1
    elif name == "chain":
        hist[:] = 0
    scal = np.array([u_pad, n_r, n_w, n_t, OLDEST + 700, OLDEST], np.int32)
    return {"hist": hist, "r_txn": r_txn, "r_live": r_live,
            "r_slot": r_slot, "w_txn": w_txn, "w_ok": w_ok, "w_slot": w_slot,
            "too_old": too_old, "scal": scal, "shape": shape}


def codes_port(c: dict, device="cpu", impl=None) -> dict:
    """intra_batch_fixpoint with the codes on codes_case's inputs."""
    t = {k: torch.from_numpy(c[k]).to(device) for k in
         (*FIX_INPUTS, "too_old", "scal")}
    codes = torch.full((c["shape"][0],), 77, dtype=torch.int8, device=device)
    conf, rounds, w_ins = fused.intra_batch_fixpoint(
        *(t[k] for k in FIX_INPUTS), c["shape"][3], impl=impl,
        codes_out=codes, scal=t["scal"], too_old=t["too_old"])
    return {"conf": conf, "rounds": rounds, "codes": codes, "w_ins": w_ins}


@functools.lru_cache(maxsize=None)
def _codes_block():
    """foundationdb_tpu/conflict/fused.py:373-405, jitted (the fixpoint's
    inputs as the reference names them: hist_conflicted, r_live, r_uid_c,
    w_base_ok, w_slot), with the while_loop's rounds counted."""
    import jax
    import jax.numpy as jnp
    from foundationdb_tpu.conflict.fused import (RES_COMMITTED, RES_CONFLICT,
                                                 RES_INVALID, RES_TOO_OLD)
    from foundationdb_tpu.ops.segtree import INF_I32

    def block(hist, r_txn, r_live, r_uid_c, w_txn, w_ok, w_slot, too_old,
              n_t, n_w, u_pad):
        t_cap, w_pad = hist.shape[0], w_txn.shape[0]
        hist_conflicted = hist != 0
        r_live, w_base_ok, too_old = r_live != 0, w_ok != 0, too_old != 0
        t_valid = jnp.arange(t_cap, dtype=jnp.int32) < n_t
        w_valid = jnp.arange(w_pad, dtype=jnp.int32) < n_w
        w_txn_c = jnp.clip(w_txn, 0, t_cap - 1)
        r_scatter = jnp.where(r_live, r_txn, t_cap)

        def body(carry):
            conf, _, rounds = carry
            w_active = w_base_ok & ~conf[w_txn_c]
            cover = jnp.full((u_pad + 1,), INF_I32, jnp.int32).at[
                jnp.where(w_active, w_slot, u_pad)].min(
                jnp.where(w_active, w_txn, INF_I32))
            intra_hit = r_live & (cover[r_uid_c] < r_txn)
            new_conf = hist_conflicted.at[r_scatter].max(intra_hit,
                                                         mode="drop")
            return new_conf, jnp.any(new_conf != conf), rounds + 1

        conflicted, _, rounds = jax.lax.while_loop(
            lambda c: c[1], body, (hist_conflicted, True, 0))
        survivor = t_valid & ~too_old & ~conflicted
        w_ins = w_valid & survivor[w_txn_c]
        codes = jnp.where(
            ~t_valid, RES_INVALID,
            jnp.where(too_old, RES_TOO_OLD,
                      jnp.where(conflicted, RES_CONFLICT, RES_COMMITTED))
        ).astype(jnp.int8)
        return conflicted, rounds, codes, w_ins

    return jax.jit(block, static_argnums=10)


def codes_reference(c: dict) -> dict:
    """The reference's fixpoint and codes (_codes_block) on the case."""
    _, _, n_w, n_t, _, _ = (int(x) for x in c["scal"])
    conf, rounds, codes, w_ins = _codes_block()(
        *(c[k] for k in (*FIX_INPUTS, "too_old")), n_t, n_w, c["shape"][3])
    return {"conf": np.asarray(conf).astype(np.int32),
            "rounds": np.array([int(rounds)], np.int32),
            "codes": np.asarray(codes),
            "w_ins": np.asarray(w_ins).astype(np.int32)}


@pytest.mark.parametrize("name", CODES_CASES)
def test_fixpoint_codes_match_reference(name):
    """conf, rounds, codes and the insert mask equal the reference's; the
    call equals the fixpoint alone followed by batch_codes."""
    c = codes_case(name)
    want = codes_reference(c)
    got = codes_port(c)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    t = {k: torch.from_numpy(c[k]) for k in (*FIX_INPUTS, "too_old", "scal")}
    conf, rounds = fused.intra_batch_fixpoint(*(t[k] for k in FIX_INPUTS),
                                              c["shape"][3])
    codes = torch.empty((c["shape"][0],), dtype=torch.int8)
    w_ins = fused.batch_codes(t["scal"], t["too_old"], conf, t["w_txn"],
                              codes)
    for k, v in (("conf", conf), ("rounds", rounds), ("codes", codes),
                 ("w_ins", w_ins)):
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    n_t = int(c["scal"][3])
    if name == "all_conflicted":
        assert not (want["codes"][:n_t] == fused.RES_COMMITTED).any()
    if name == "chain":
        assert want["rounds"][0] >= 20
    if name in ("txn_minus_1", "mixed") and n_t:
        assert c["w_txn"][0] == -1 and c["r_txn"][0] == -1
    if name == "n_zero":
        assert (want["codes"] == fused.RES_INVALID).all()
        assert not want["w_ins"].any()


def test_fixpoint_codes_need_their_inputs():
    c = codes_case("mixed")
    t = {k: torch.from_numpy(c[k]) for k in FIX_INPUTS}
    with pytest.raises(ValueError):
        fused.intra_batch_fixpoint(*(t[k] for k in FIX_INPUTS),
                                   c["shape"][3],
                                   codes_out=torch.empty((64,), dtype=torch.int8))


# ---------------------------------------------------------------------------
# general_prep
# ---------------------------------------------------------------------------

META_KEYS = ("r_txn", "r_valid", "w_txn", "w_valid", "t_snap",
             "t_has_reads", "t_valid")


def gprep_case(name: str, seed: int = 0, t_cap: int = 64, r_cap: int = 256,
               w_cap: int = 128) -> dict:
    """general_prep's inputs for one named case (int32 numpy): the
    metadata block (meta_size's layout) and each read's history maximum
    vmax; shapes under "shape": (t_cap, r_cap, w_cap).  Padding reads and
    writes carry txn ids out of range."""
    if name == "t_cap_1":
        t_cap, r_cap, w_cap = 1, 9, 5
    rng = np.random.default_rng(seed + 11 * GPREP_CASES.index(name))
    n_t = {"n_zero": 0, "n_full": t_cap}.get(name, max(t_cap - 5, 1))
    n_r = {"n_zero": 0, "n_full": r_cap}.get(name, r_cap - 7)
    n_w = {"n_zero": 0, "n_full": w_cap}.get(name, w_cap - 3)
    t_valid = (np.arange(t_cap) < n_t).astype(np.int32)
    t_has_reads = (rng.random(t_cap) < 0.8).astype(np.int32)
    if name == "writes_no_reads":
        t_has_reads[:] = 0
    t_snap = rng.integers(OLDEST - 300, OLDEST + 700,
                          size=t_cap).astype(np.int32)
    if name == "too_old_writers":
        t_snap[::2] = OLDEST - 1
    if name == "snap_eq_oldest":
        t_snap[:] = OLDEST
    if name == "writes_no_reads":
        t_snap[::2] = OLDEST - 1
    r_txn = _txns(rng, n_r, r_cap, -1, n_t)
    w_txn = _txns(rng, n_w, w_cap, -1, n_t)
    r_txn[n_r:] = rng.integers(-3, t_cap + 4, size=r_cap - n_r)
    w_txn[n_w:] = rng.integers(-3, t_cap + 4, size=w_cap - n_w)
    if name == "txn_minus_1":
        r_txn[:n_r // 4] = -1
        w_txn[:n_w // 4] = -1
        t_snap[0] = OLDEST + 600         # txn 0, whose flags txn -1 reads
    elif n_r:
        r_txn[:min(3, n_r)] = -1
        w_txn[:min(2, n_w)] = -1
    r_valid = ((np.arange(r_cap) < n_r)
               & (rng.random(r_cap) < 0.95)).astype(np.int32)
    w_valid = ((np.arange(w_cap) < n_w)
               & (rng.random(w_cap) < 0.95)).astype(np.int32)
    if name == "n_full":
        r_valid[:], w_valid[:] = 1, 1
    vmax = rng.integers(OLDEST - 200, OLDEST + 900,
                        size=r_cap).astype(np.int32)
    vmax[rng.random(r_cap) < 0.2] = np.iinfo(np.int32).min + 1  # NEG_INF
    if name in ("all_conflicted", "txn_minus_1"):
        vmax[:] = OLDEST + 10_000
    arrays = {"r_txn": r_txn, "r_valid": r_valid, "w_txn": w_txn,
              "w_valid": w_valid, "t_snap": t_snap,
              "t_has_reads": t_has_reads, "t_valid": t_valid}
    meta = np.concatenate([*(arrays[k] for k in META_KEYS),
                           np.array([OLDEST + 700, OLDEST], np.int32)])
    assert meta.shape[0] == fused.meta_size(t_cap, r_cap, w_cap)
    return {"meta": meta, "vmax": vmax, "shape": (t_cap, r_cap, w_cap)}


def gprep_port(c: dict, device="cpu", impl=None, offset: int = 0) -> dict:
    """general_prep on gprep_case's inputs, the metadata block's views as
    unpack_meta gives them; with `offset`, the block starts that many
    int32s into its buffer (no 16-byte loads)."""
    buf = torch.zeros((offset + c["meta"].shape[0],), dtype=torch.int32)
    buf[offset:] = torch.from_numpy(c["meta"])
    m = fused.unpack_meta(buf.to(device)[offset:], *c["shape"])
    return fused.general_prep(m, torch.from_numpy(c["vmax"]).to(device),
                              impl)


@functools.lru_cache(maxsize=None)
def _gprep_block():
    """foundationdb_tpu/conflict/fused.py:479-511, jitted (the one-device
    branch: every live read's history is its own), vmax in the place of
    jnp.maximum(max_base, max_delta)."""
    import jax
    import jax.numpy as jnp

    def block(meta, vmax, t_cap, r_cap, w_cap):
        o = 0
        r_txn = meta[o:o + r_cap]; o += r_cap
        r_valid = meta[o:o + r_cap] != 0; o += r_cap
        w_txn = meta[o:o + w_cap]; o += w_cap
        w_valid = meta[o:o + w_cap] != 0; o += w_cap
        t_snap = meta[o:o + t_cap]; o += t_cap
        t_has_reads = meta[o:o + t_cap] != 0; o += t_cap
        t_valid = meta[o:o + t_cap] != 0; o += t_cap
        oldest_rel = meta[o + 1]
        too_old = t_valid & t_has_reads & (t_snap < oldest_rel)
        r_txn_c = jnp.clip(r_txn, 0, t_cap - 1)
        r_live = r_valid & ~too_old[r_txn_c]
        snap_r = t_snap[r_txn_c]
        r_hist_live = r_live
        hist_bits = r_hist_live & (vmax > snap_r)
        r_scatter = jnp.where(r_live, r_txn, t_cap)
        hist_conflicted = jnp.zeros((t_cap,), bool).at[r_scatter].max(
            hist_bits, mode="drop")
        w_txn_c = jnp.clip(w_txn, 0, t_cap - 1)
        w_base_ok = w_valid & ~too_old[w_txn_c]
        return {"too_old": too_old, "r_live": r_live,
                "hist": hist_conflicted, "w_ok": w_base_ok}

    return jax.jit(block, static_argnums=(2, 3, 4))


def gprep_reference(c: dict) -> dict:
    """The reference's general prep (_gprep_block) on the case."""
    out = _gprep_block()(c["meta"], c["vmax"], *c["shape"])
    return {k: np.asarray(v).astype(np.int32) for k, v in out.items()}


@pytest.mark.parametrize("name", GPREP_CASES)
def test_general_prep_matches_reference(name):
    """too_old, r_live, hist and w_ok equal the reference's."""
    c = gprep_case(name)
    want = gprep_reference(c)
    got = gprep_port(c)
    assert list(got) == ["too_old", "r_live", "hist", "w_ok"]
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    if name in ("writes_no_reads", "snap_eq_oldest", "n_zero"):
        assert not want["too_old"].any()
    if name == "too_old_writers":
        assert want["too_old"].any() and not want["w_ok"].all()
    if name == "txn_minus_1":
        assert want["hist"][-1] == 1
    if name == "all_conflicted":  # every live read's txn, -1 at the end
        hit = c["meta"][:c["shape"][1]][want["r_live"] != 0]
        assert hit.size and want["hist"][hit].all()
