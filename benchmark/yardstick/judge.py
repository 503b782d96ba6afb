"""What decides `correct`: the records each call wrote against the planted
truth of its shard, and the PairHMM likelihoods the window's launches
returned against the plain PairHMM. It imports nothing of the program.

A planted SNV is found when a record at its position has its REF, its ALT
among the ALTs and, for a germline caller, its GT (heterozygous, or
homozygous for a variant on both haplotypes); a planted indel
when a record within INDEL_SLACK bp changes the length by as much (an indel
in a repeat is reported left-aligned), as chip_smoke.py's gates judge them.
A record that finds no planted variant and calls a non-reference allele is a
false record. A GVCF's records (variant sites and reference blocks, END in
INFO) must cover every base of the shard exactly once.
"""
from __future__ import annotations

import numpy as np

INDEL_SLACK = 20
NON_REF = "<NON_REF>"
HET = {"0/1", "0|1", "1|0"}
HOM = {"1/1", "1|1"}
FLOOR = -28.0  # log10: the program clamps or recomputes what lies at or below it


def parse_records(text):
    """VCF text -> [dict(pos (0-based), ref, alts, gt, end (0-based, exclusive))]."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        f = line.split("\t")
        pos = int(f[1]) - 1
        alts = f[4].split(",")
        end = pos + len(f[3])
        for kv in f[7].split(";"):
            if kv.startswith("END="):
                end = int(kv[4:])
        gt = f[9].split(":")[0] if len(f) > 9 else ""
        out.append(dict(pos=pos, ref=f[3], alts=alts, gt=gt, end=end))
    return out


def _called(rec):
    """A record that calls a non-reference allele (not a reference block and
    not a hom-ref genotype)."""
    real = [a for a in rec["alts"] if a not in (NON_REF, ".", "*")]
    alleles = rec["gt"].replace("|", "/").split("/")
    return bool(real) and any(a not in ("0", ".") for a in alleles)


def _length_changes(rec):
    return {len(rec["ref"]) - len(a) for a in rec["alts"] if a not in (NON_REF, ".", "*")}


def judge_shard(records, shard, kinds, germline_gt=True, tiled=False):
    """Counts for one call: for each kind in `kinds` (germline, somatic) its
    planted SNVs and indels and how many were missed; false records; and with
    `tiled` the bases of [shard.start, shard.end) not covered exactly once."""
    out = {}
    used = set()
    for kind in kinds:
        planted = [v for v in shard.variants if v.kind == kind]
        snv_miss = indel_miss = 0
        for v in planted:
            if v.is_snv:
                hit = [k for k, r in enumerate(records)
                       if r["pos"] == v.pos and r["ref"] == v.ref and v.alt in r["alts"]
                       and (not germline_gt or r["gt"] in (HOM if v.af == 1.0 else HET))]
                snv_miss += not hit
            else:
                change = len(v.ref) - len(v.alt)
                hit = [k for k, r in enumerate(records)
                       if abs(r["pos"] - v.pos) <= INDEL_SLACK and change in _length_changes(r)]
                indel_miss += not hit
            used.update(hit)
        out[f"{kind}_snv"] = sum(v.is_snv for v in planted)
        out[f"{kind}_snv_missed"] = snv_miss
        out[f"{kind}_indel"] = sum(not v.is_snv for v in planted)
        out[f"{kind}_indel_missed"] = indel_miss
    out["records"] = len(records)
    out["false_records"] = sum(1 for k, r in enumerate(records) if k not in used and _called(r))
    if tiled:
        depth = np.zeros(shard.end - shard.start, np.int64)
        for r in records:
            lo, hi = max(r["pos"], shard.start), min(r["end"], shard.end)
            if hi > lo:
                depth[lo - shard.start : hi - shard.start] += 1
        out["untiled_bases"] = int((depth != 1).sum())
    return out


def likelihood_gap(kernel, reference, floor=FLOOR):
    """Widest |kernel - reference| over the pairs, both taken at the floor the
    program applies (a value at or below it, or NaN, counts as the floor)."""
    k = np.asarray(kernel, np.float64)
    r = np.asarray(reference, np.float64)
    if not len(k):
        return None
    k = np.where(k > floor, k, floor)
    r = np.where(r > floor, r, floor)
    return float(np.abs(k - r).max())


def numbers(totals, gap, failed, n_calls):
    """The numbers a run compares, from the summed counts of its calls: each
    share of planted variants missed (None where none was planted), false
    records per call, untiled bases, the likelihood gap, failed calls."""
    out = {"failed_calls": failed}
    for kind in ("germline", "somatic"):
        for what in ("snv", "indel"):
            n = totals.get(f"{kind}_{what}", 0)
            if n:
                out[f"{kind}_{what}_missed_share"] = totals[f"{kind}_{what}_missed"] / n
    out["false_records_per_call"] = totals.get("false_records", 0) / max(n_calls, 1)
    if "untiled_bases" in totals:
        out["untiled_bases"] = totals["untiled_bases"]
    if gap is not None:
        out["pairhmm_max_gap"] = gap
    return out


def verdict(nums, limits):
    """[(name, value, limit, ok)] for every number that has a limit: {name:
    {"limit": x, "required": bool}}. A required number with no reading fails
    (an answer that never came); one that is not required has no reading
    where the window's shards planted nothing of its kind."""
    rows = []
    for name, spec in limits.items():
        value = nums.get(name)
        if value is None:
            ok = not spec.get("required", True)
        else:
            ok = value <= spec["limit"]
        rows.append((name, value, spec["limit"], ok))
    return rows
