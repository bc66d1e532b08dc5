"""Disagreement classifier for traversal A/B tests.

The reference's culture is pixel-exact A/B (voxRT.cpp:316-323). Two exact
in-order walkers can still legitimately disagree in two zero-measure cases:

  * t-tie: the ray passes through a shared voxel edge/corner, two voxels
    tie at the same entry distance, and either (voxel, face) answer is
    valid;
  * grazing touch vs the brute-force slab oracle: a ray along a voxel FACE
    or EDGE has a degenerate [entry, exit] interval that the inclusive slab
    test reports and the strict `en < ex` parametric walk excludes (matches
    the reference traversal's strict comparisons, voxCommon.hpp:326-334).

Instead of tolerating an unclassified mismatch budget (round-1 weakness:
0.5% could hide a systematic bug), every single disagreement must PROVE it
is one of the two cases above or the test fails."""

import numpy as np

from massivevoxelraytracing_tpu.ops import morton as morton_ops

F = np.float32


def _slab(m_voxel, lower, dps, ro, rd):
    """(entry, exit) of one voxel's AABB along the ray (inclusive slab)."""
    x, y, z = morton_ops.np_decode(np.asarray([m_voxel], np.uint64))
    lo = np.asarray(lower, F) + np.stack([x, y, z], -1).astype(F)[0] * F(dps)
    hi = lo + F(dps)
    en, ex = -np.inf, np.inf
    for a in range(3):
        if rd[a] == 0.0:
            if not (lo[a] <= ro[a] <= hi[a]):
                return np.inf, -np.inf
            continue
        t0 = (lo[a] - ro[a]) / rd[a]
        t1 = (hi[a] - ro[a]) / rd[a]
        en = max(en, min(t0, t1))
        ex = min(ex, max(t0, t1))
    return en, ex


def assert_tie_or_equal(i, t1, v1, m1, t2, v2, m2, rtol=1e-5, atol=1e-7):
    """Between two exact walkers: a disagreement must be a t-tie."""
    hit1 = t1 < 1e37
    hit2 = t2 < 1e37
    assert hit1 == hit2, f"ray {i}: hit-mask mismatch ({t1} vs {t2})"
    if not hit1:
        return
    assert np.isclose(t1, t2, rtol=rtol, atol=atol), (
        f"ray {i}: t differs beyond tie tolerance: {t1} vs {t2}"
    )
    # equal t, different (voxel, face): a legitimate corner/edge tie


def classify_vs_each_other(t1, m1, v1, t2, m2, v2, rtol=1e-5, atol=1e-7):
    """Vectorized outer check + per-ray classification of the residue."""
    hit1 = t1 < 1e37
    hit2 = t2 < 1e37
    agree = (hit1 == hit2) & (
        ~hit1 | (np.isclose(t1, t2, rtol=rtol, atol=atol)
                 & (v1 == v2) & (m1 == m2))
    )
    for i in np.nonzero(~agree)[0]:
        assert_tie_or_equal(
            i, t1[i], v1[i], m1[i], t2[i], v2[i], m2[i], rtol=rtol, atol=atol
        )
    return int((~agree).sum())


def assert_face_tie(i, m_voxel, lower, dps, ro, rd, rtol=1e-5):
    """A differing face axis at the SAME hit voxel and t is only legitimate
    when the voxel entry is achieved on >= 2 axes simultaneously (edge /
    corner entry). Verify from the per-axis slab times."""
    x, y, z = morton_ops.np_decode(np.asarray([m_voxel], np.uint64))
    lo = np.asarray(lower, F) + np.stack([x, y, z], -1).astype(F)[0] * F(dps)
    hi = lo + F(dps)
    tmins = []
    for a in range(3):
        if rd[a] == 0.0:
            continue
        t0 = (lo[a] - ro[a]) / rd[a]
        t1 = (hi[a] - ro[a]) / rd[a]
        tmins.append(min(t0, t1))
    tmins.sort()
    assert len(tmins) >= 2 and np.isclose(
        tmins[-1], tmins[-2], rtol=rtol, atol=1e-7
    ), f"ray {i}: face-axis mismatch without an axis tie (tmins={tmins})"


def classify_vs_oracle(
    i, m_sorted, lower, dps, ro, rd, t_dev, v_dev, t_ora, v_ora,
    rtol=2e-5, atol=1e-6, graze_eps=1e-4,
):
    """Device walker vs the inclusive brute-force slab oracle: any
    disagreement must be a t-tie or a grazing touch of the oracle's voxel.
    Returns a short tag describing the classified case (for reporting)."""
    dev_hit = t_dev < 1e37
    ora_hit = np.isfinite(t_ora)
    if dev_hit == ora_hit and dev_hit:
        if np.isclose(t_dev, t_ora, rtol=rtol, atol=atol):
            return "tie"  # same t, differing voxel/face at an edge
    if ora_hit:
        en, ex = _slab(m_sorted[int(v_ora)], lower, dps, ro, rd)
        scale = max(1.0, abs(en))
        if ex - en <= graze_eps * scale:
            # oracle counted a zero-measure touch; the walker's answer (miss
            # or a later real hit) must not be EARLIER than the graze
            if not dev_hit or t_dev >= en - rtol * scale:
                return "graze"
    raise AssertionError(
        f"ray {i}: unclassified disagreement: dev(t={t_dev}, v={v_dev}) "
        f"vs oracle(t={t_ora}, v={v_ora})"
    )


def classify_all_vs_oracle(m_sorted, lower, dps, ro, rd, t, nmaj, vidx):
    """Every ray of a device walk vs the brute-force slab oracle
    (cpu_oracle.intersect_brute_force). A ray that disagrees must classify
    as a face tie, a t-tie or a grazing touch, or this raises. Returns the
    number of rays that needed classifying."""
    from massivevoxelraytracing_tpu.models import cpu_oracle

    n_classified = 0
    for i in range(len(ro)):
        to, no, vo = cpu_oracle.intersect_brute_force(
            m_sorted, lower, dps, ro[i], rd[i]
        )
        dev_hit = t[i] < 1e37
        ora_hit = np.isfinite(to)
        same_t = dev_hit and ora_hit and np.isclose(
            t[i], to, rtol=2e-5, atol=1e-6
        )
        if dev_hit == ora_hit and (
            not dev_hit or (same_t and vidx[i] == vo and nmaj[i] == no)
        ):
            continue
        n_classified += 1
        if same_t and vidx[i] == vo:
            # same voxel, same t, different face: must be an axis tie
            assert_face_tie(i, m_sorted[int(vo)], lower, dps, ro[i], rd[i])
        else:
            classify_vs_oracle(
                i, m_sorted, lower, dps, ro[i], rd[i], t[i], vidx[i], to, vo
            )
    return n_classified


def entry_t_tolerance(m_voxel, lower, dps, ro, rd, extent):
    """Float32 error bound on a walker's entry distance into a voxel. The
    entry is the plane crossing on the voxel's entry axis a, and a walker
    derives it from root-box quantities as large as (|ro| + extent)/|rd_a|
    (extent = the root box's side), rounding about 4 operations per tree
    level: some 75 ulp of that over an 11-level octree walk plus a 6-level
    brick walk. Allow 128."""
    x, y, z = morton_ops.np_decode(np.asarray([m_voxel], np.uint64))
    lo = np.asarray(lower, F) + np.stack([x, y, z], -1).astype(F)[0] * F(dps)
    tmin = np.full(3, -np.inf)
    for a in range(3):
        if rd[a] != 0.0:
            tmin[a] = min((lo[a] - ro[a]) / rd[a], (lo[a] + dps - ro[a]) / rd[a])
    a = int(np.argmax(tmin))
    scale = float(np.abs(ro).max()) + float(extent)
    return 128 * float(np.finfo(F).eps) * scale / abs(float(rd[a]))


def classify_walkers_vs_each_other(m_sorted, lower, dps, extent, ro, rd,
                                   t1, m1, v1, t2, m2, v2, rtol=1e-5,
                                   atol=1e-7):
    """Two exact walkers over the same voxels, at a scale where their
    different float paths matter. Every disagreement must be a t-tie (the
    same entry plane up to entry_t_tolerance), or the EARLIER hit must be a
    grazing touch of its own voxel (zero-measure slab, checked
    geometrically) that the other walker legitimately skipped. Raises
    after the whole pass, listing the unclassified rays; returns the
    number of rays that needed classifying."""
    hit1 = t1 < 1e37
    hit2 = t2 < 1e37
    agree = (hit1 == hit2) & (
        ~hit1 | (np.isclose(t1, t2, rtol=rtol, atol=atol)
                 & (v1 == v2) & (m1 == m2))
    )
    bad = np.nonzero(~agree)[0]
    failures = []
    for i in bad:
        first = 1 if hit1[i] and (not hit2[i] or t1[i] <= t2[i]) else 2
        ta, va = (t1[i], v1[i]) if first == 1 else (t2[i], v2[i])
        tb, vb = (t2[i], v2[i]) if first == 1 else (t1[i], v1[i])
        if hit1[i] and hit2[i] and abs(float(ta) - float(tb)) <= max(
                entry_t_tolerance(m_sorted[int(va)], lower, dps, ro[i],
                                  rd[i], extent),
                rtol * abs(float(ta)) + atol):
            continue  # the same entry plane up to float error: a t-tie
        try:
            # the earlier walker plays the inclusive oracle's role
            classify_vs_oracle(i, m_sorted, lower, dps, ro[i], rd[i], tb, vb,
                               float(ta), va)
        except AssertionError as e:
            failures.append(str(e))
    if failures:
        raise AssertionError(
            f"{len(failures)} of {len(bad)} disagreements unclassified, "
            f"e.g.: " + " | ".join(failures[:5]))
    return len(bad)
