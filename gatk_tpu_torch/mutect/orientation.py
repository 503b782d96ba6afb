# Copied verbatim from gatk_tpu/mutect/orientation.py; only import lines may differ.
"""Read-orientation artifact model (F1R2/F2R1 strand bias learning).

Reference behavior: tools/walkers/readorientation/ —
F1R2CountsCollector.java:88-160 (per-locus pileup counting into ref/alt
histograms + alt design matrix), LearnReadOrientationModelEngine.java:140-300
(EM over the 12-state artifact mixture with beta-binomial likelihoods),
ArtifactPrior(.java)/ArtifactPriorCollection.java (the .orientation_priors
table), LearnReadOrientationModel.java:118-175 (revcomp merging of canonical
k-mer pairs), and mutect/filtering/ReadOrientationFilter.java (posterior
artifact probability per variant from F1R2/F2R1 genotype counts).

TPU-first layout: the collection pass is a scatter-add over (locus x base x
orientation) count tensors (no per-locus object pileups), and the EM runs as a
dense (rows x 12 states) matrix program per context — log-prior broadcast +
precomputed beta-binomial data log-likelihoods, row-logsumexp normalization.
"""
from __future__ import annotations

import io
import math
import os
import tarfile
from dataclasses import dataclass, field

import numpy as np
from scipy.special import gammaln

from ..engine import pileup as pileup_mod

# ---------------------------------------------------------------------------
# constants (F1R2FilterConstants.java)
# ---------------------------------------------------------------------------

BASES = "ACGT"
COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}
REF_CONTEXT_PADDING = 1
CONTEXT_SIZE = 2 * REF_CONTEXT_PADDING + 1
DEFAULT_MAX_DEPTH = 200
DEFAULT_CONVERGENCE_THRESHOLD = 1e-4
DEFAULT_MAX_EM_ITERATIONS = 20

# kmer enumeration order mirrors SequenceUtil.generateAllKmers (A,C,G,T radix)
ALL_KMERS = [a + b + c for a in BASES for b in BASES for c in BASES]
KMER_INDEX = {k: i for i, k in enumerate(ALL_KMERS)}


def reverse_complement(s: str) -> str:
    return "".join(COMPLEMENT[c] for c in reversed(s))


# canonical kmer of each revcomp pair = lexicographically smaller
CANONICAL_KMERS = sorted({min(k, reverse_complement(k)) for k in ALL_KMERS})

# 12 artifact states, ordinal order matches ArtifactState.java
STATES = [
    "F1R2_A", "F1R2_C", "F1R2_G", "F1R2_T",
    "F2R1_A", "F2R1_C", "F2R1_G", "F2R1_T",
    "HOM_REF", "GERMLINE_HET", "SOMATIC_HET", "HOM_VAR",
]
NUM_STATES = len(STATES)
STATE_INDEX = {s: i for i, s in enumerate(STATES)}
F1R2, F2R1 = 0, 1  # ReadOrientation ordinals

# state -> alt base index (artifact states only; -1 for non-artifact)
STATE_ALT = np.array([0, 1, 2, 3, 0, 1, 2, 3, -1, -1, -1, -1])
IS_ARTIFACT = STATE_ALT >= 0

# reverse complement of each state: F1R2_X <-> F2R1_complement(X)
REVCOMP_STATE = np.array([STATE_INDEX[
    ("F2R1_" if s.startswith("F1R2") else "F1R2_") + COMPLEMENT[s[-1]]
] if s[0] == "F" else STATE_INDEX[s] for s in STATES])

# beta-binomial hyperparameters per state (LearnReadOrientationModelEngine.java:78-108)
_ALT_PSEUDO, _REF_PSEUDO = 1.0, 9.0
_HOM_LIKELY, _HOM_UNLIKELY = 10000.0, 3.0
_BALANCED_HET = 5.0
_BALANCED_F1R2 = 10.0
_SOMATIC_ALT, _SOMATIC_REF = 2.0, 5.0
_LIKELY, _RARE = 100.0, 1.0

# allele-fraction beta shape (alpha, beta) per state
AF_ALPHA = np.array([_ALT_PSEUDO] * 8 + [_HOM_UNLIKELY, _BALANCED_HET, _SOMATIC_ALT, _HOM_LIKELY])
AF_BETA = np.array([_REF_PSEUDO] * 8 + [_HOM_LIKELY, _BALANCED_HET, _SOMATIC_REF, _HOM_UNLIKELY])
# alt-F1R2-fraction beta shape per state
T_ALPHA = np.array([_LIKELY] * 4 + [_RARE] * 4 + [_BALANCED_F1R2] * 4)
T_BETA = np.array([_RARE] * 4 + [_LIKELY] * 4 + [_BALANCED_F1R2] * 4)


def flat_prior(ref_base_idx: int) -> np.ndarray:
    """Uniform prior over the 10 allowed states (ref->ref artifacts get 0)."""
    pi = np.full(NUM_STATES, 1.0 / (NUM_STATES - 2))
    pi[ref_base_idx] = 0.0          # F1R2_<ref>
    pi[4 + ref_base_idx] = 0.0      # F2R1_<ref>
    return pi


# ---------------------------------------------------------------------------
# beta-binomial
# ---------------------------------------------------------------------------

def _betaln(a, b):
    return gammaln(a) + gammaln(b) - gammaln(a + b)


def betabinom_logpmf(k, n, alpha, beta):
    """log P(k | n, alpha, beta) of the beta-binomial (matches
    BetaBinomialDistribution.logProbability)."""
    k = np.asarray(k, np.float64)
    n = np.asarray(n, np.float64)
    log_choose = gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
    return log_choose + _betaln(k + alpha, n - k + beta) - _betaln(alpha, beta)


def _data_loglik(alt_idx, alt_count, alt_f1r2, depth, ref_base_idx):
    """(rows, NUM_STATES) beta-binomial data log-likelihood with state masks.

    alt_idx: observed alt base index (== ref_base_idx for ref sites).
    """
    alt_idx = np.asarray(alt_idx)
    rows = alt_idx.shape[0]
    ll = betabinom_logpmf(alt_count[:, None], depth[:, None], AF_ALPHA, AF_BETA)
    ll = ll + betabinom_logpmf(alt_f1r2[:, None], alt_count[:, None], T_ALPHA, T_BETA)
    # mask: artifact states must match the observed alt; ref->ref artifacts never allowed
    mask = IS_ARTIFACT[None, :] & (STATE_ALT[None, :] != alt_idx[:, None])
    mask = mask | (IS_ARTIFACT[None, :] & (STATE_ALT[None, :] == ref_base_idx))
    ll = np.where(mask, -np.inf, ll)
    return ll


def compute_responsibilities(ref_base_idx, alt_idx, alt_count, alt_f1r2, depth, pi,
                             given_not_hom_ref=False):
    """Posterior over the 12 states for one site (ReadOrientationFilter path)."""
    ll = _data_loglik(np.array([alt_idx]), np.array([alt_count]),
                      np.array([alt_f1r2]), np.array([depth]), ref_base_idx)[0]
    with np.errstate(divide="ignore"):
        logpost = np.log(pi) + ll
    if given_not_hom_ref:
        logpost[STATE_INDEX["HOM_REF"]] = -np.inf
    m = logpost.max()
    p = np.exp(logpost - m)
    return p / p.sum()


# ---------------------------------------------------------------------------
# EM engine (per canonical reference context)
# ---------------------------------------------------------------------------

@dataclass
class ArtifactPrior:
    context: str
    pi: np.ndarray
    num_examples: int
    num_alt_examples: int

    def reverse_complement(self):
        return ArtifactPrior(reverse_complement(self.context), self.pi[REVCOMP_STATE].copy(),
                             self.num_examples, self.num_alt_examples)


def learn_context(context: str, ref_hist: np.ndarray, alt_hist: np.ndarray,
                  alt_rows: np.ndarray, max_depth=DEFAULT_MAX_DEPTH,
                  convergence_threshold=DEFAULT_CONVERGENCE_THRESHOLD,
                  max_iterations=DEFAULT_MAX_EM_ITERATIONS) -> ArtifactPrior:
    """EM for one canonical context.

    ref_hist: (max_depth,) counts of ref sites by depth (bin d = depth d+1).
    alt_hist: (4, 2, max_depth) depth-1 alt site counts by (alt base, orientation, depth).
    alt_rows: (N, 4) int array of (alt_idx, alt_count, alt_f1r2, depth).
    """
    ref_base_idx = BASES.index(context[REF_CONTEXT_PADDING])
    depths = np.arange(1, max_depth + 1)

    # assemble all weighted rows: ref sites, design-matrix alt sites, depth-1 alt sites
    row_alt, row_m, row_x, row_n, row_w = [], [], [], [], []
    row_alt.append(np.full(max_depth, ref_base_idx))
    row_m.append(np.zeros(max_depth, np.int64))
    row_x.append(np.zeros(max_depth, np.int64))
    row_n.append(depths)
    row_w.append(ref_hist.astype(np.float64))
    if len(alt_rows):
        row_alt.append(alt_rows[:, 0])
        row_m.append(alt_rows[:, 1])
        row_x.append(alt_rows[:, 2])
        row_n.append(alt_rows[:, 3])
        row_w.append(np.ones(len(alt_rows)))
    for a in range(4):
        if a == ref_base_idx:
            continue
        for o in (F1R2, F2R1):
            row_alt.append(np.full(max_depth, a))
            row_m.append(np.ones(max_depth, np.int64))
            row_x.append(np.full(max_depth, 1 if o == F1R2 else 0))
            row_n.append(depths)
            row_w.append(alt_hist[a, o].astype(np.float64))
    alt_idx = np.concatenate(row_alt)
    m = np.concatenate(row_m)
    x = np.concatenate(row_x)
    n = np.concatenate(row_n)
    w = np.concatenate(row_w)

    ll = _data_loglik(alt_idx, m, x, n, ref_base_idx)

    pseudo = flat_prior(ref_base_idx)
    pi = pseudo.copy()
    for _ in range(max_iterations):
        old = pi.copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            logpost = np.log(pi)[None, :] + ll
        mx = logpost.max(axis=1, keepdims=True)
        p = np.exp(logpost - mx)
        p /= p.sum(axis=1, keepdims=True)
        eff = w @ p
        pi = eff + pseudo
        pi /= pi.sum()
        if np.linalg.norm(pi - old) <= convergence_threshold:
            break

    num_ref = int(ref_hist.sum())
    num_alt = int(len(alt_rows) + alt_hist.sum())
    return ArtifactPrior(context, pi, num_ref + num_alt, num_alt)


# ---------------------------------------------------------------------------
# F1R2 counts collection (F1R2CountsCollector.java)
# ---------------------------------------------------------------------------

@dataclass
class F1R2Counts:
    """Per-sample F1R2 count data over all 64 contexts."""
    sample: str
    max_depth: int = DEFAULT_MAX_DEPTH
    # (64, max_depth): ref site depth histogram per context
    ref_hist: np.ndarray = None
    # (64, 4, 2, max_depth): depth-one alt histograms (context, alt, orientation, depth)
    alt_hist: np.ndarray = None
    # list of (context_idx, alt_idx, ref_count, alt_count, ref_f1r2, alt_f1r2)
    alt_rows: list = field(default_factory=list)

    def __post_init__(self):
        if self.ref_hist is None:
            self.ref_hist = np.zeros((64, self.max_depth), np.float64)
        if self.alt_hist is None:
            self.alt_hist = np.zeros((64, 4, 2, self.max_depth), np.float64)

    def add(self, other: "F1R2Counts"):
        self.ref_hist += other.ref_hist
        self.alt_hist += other.alt_hist
        self.alt_rows.extend(other.alt_rows)


_BASE_TO_IDX = np.full(256, -1, np.int8)
for _i, _b in enumerate(BASES):
    _BASE_TO_IDX[ord(_b)] = _i
    _BASE_TO_IDX[ord(_b.lower())] = _i


def collect_f1r2_counts(reads, ref_bases: bytes, shard_start: int, counts: F1R2Counts,
                        min_bq=20, min_median_mq=50):
    """Accumulate F1R2 counts over one reference shard.

    reads: filtered reads overlapping [shard_start, shard_start + len(ref_bases)).
    Vectorized as scatter-adds over per-locus (base x orientation) count planes
    (F1R2CountsCollector.process semantics, single sample).
    """
    L = len(ref_bases)
    if L == 0 or not reads:
        return
    base_counts = np.zeros((L, 4), np.int32)      # qual-filtered base counts
    f1r2_counts = np.zeros((L, 4), np.int32)      # of those, F1R2 reads
    indel_flags = np.zeros(L, np.int32)           # before-del / after-ins elements
    raw_elements = np.zeros(L, np.int32)          # all surviving elements incl. deletions
    mq_hist = np.zeros((L, 256), np.int32)        # mapq histogram for median

    for read in reads:
        pos, base, qual, flags = pileup_mod.expand_read(read)
        rel = pos - shard_start
        keep = (rel >= 0) & (rel < L) & (qual > min_bq)
        if not keep.any():
            continue
        rel = rel[keep]
        b = _BASE_TO_IDX[base[keep]]
        fl = flags[keep]
        np.add.at(raw_elements, rel, 1)
        np.add.at(mq_hist, (rel, min(read.mapq, 255)), 1)
        np.add.at(indel_flags, rel,
                  ((fl & (pileup_mod.F_BEFORE_DELETION | pileup_mod.F_AFTER_INSERTION)) != 0)
                  .astype(np.int32))
        ok = b >= 0
        if not ok.any():
            continue
        is_f1r2 = read.is_f1r2
        np.add.at(base_counts, (rel[ok], b[ok]), 1)
        if is_f1r2:
            np.add.at(f1r2_counts, (rel[ok], b[ok]), 1)

    depth = base_counts.sum(axis=1)
    # median mapq per locus from the histogram
    cum = np.cumsum(mq_hist, axis=1)
    total = raw_elements
    # lower median (MathUtils.median uses 50th percentile; even sizes average —
    # integers round the same way for our gate in practice)
    half = (total + 1) // 2
    med_mq = np.argmax(cum >= np.maximum(half, 1)[:, None], axis=1)

    ref_arr = np.frombuffer(ref_bases, np.uint8)
    ref_idx = _BASE_TO_IDX[ref_arr]

    # context index per locus (requires flanking bases within shard and non-N)
    ctx_ok = np.zeros(L, bool)
    ctx_ok[1:-1] = (ref_idx[:-2] >= 0) & (ref_idx[1:-1] >= 0) & (ref_idx[2:] >= 0)
    ctx_index = np.zeros(L, np.int64)
    ctx_index[1:-1] = (ref_idx[:-2].astype(np.int64) * 16 + ref_idx[1:-1] * 4
                       + ref_idx[2:])

    good = (
        ctx_ok
        & (depth > 0)
        & (indel_flags <= total // 100)
        & (raw_elements > 0)
        & (med_mq >= min_median_mq)
    )
    loci = np.nonzero(good)[0]
    if len(loci) == 0:
        return

    bc = base_counts[loci]
    f1 = f1r2_counts[loci]
    ref_i = ref_idx[loci].astype(np.int64)
    ctx = ctx_index[loci]
    d = depth[loci]

    # alt base = argmax of non-ref counts (first max wins on ties, as in
    # MathUtils.maxElementIndex over the ref-masked copy)
    masked = bc.copy()
    masked[np.arange(len(loci)), ref_i] = -1
    alt_i = masked.argmax(axis=1)
    alt_count = bc[np.arange(len(loci)), alt_i]

    is_ref_site = alt_count == 0
    capped = np.minimum(d, counts.max_depth) - 1
    np.add.at(counts.ref_hist, (ctx[is_ref_site], capped[is_ref_site]), 1)

    alt_sites = np.nonzero(~is_ref_site)[0]
    for j in alt_sites:
        ai = int(alt_i[j])
        ac = int(alt_count[j])
        a_f1r2 = int(f1[j, ai])
        if ac == 1:
            orient = F1R2 if a_f1r2 == 1 else F2R1
            counts.alt_hist[ctx[j], ai, orient, int(capped[j])] += 1
        else:
            rc = int(bc[j, ref_i[j]])
            r_f1r2 = int(f1[j, ref_i[j]])
            counts.alt_rows.append((int(ctx[j]), ai, rc, ac, r_f1r2, a_f1r2))


# ---------------------------------------------------------------------------
# tar.gz file formats (Picard metrics histograms + GATK TSV tables)
# ---------------------------------------------------------------------------

REF_HIST_EXT = ".ref_histogram"
ALT_HIST_EXT = ".alt_histogram"
ALT_TABLE_EXT = ".alt_table"
PRIORS_EXT = ".orientation_priors"


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _metrics_histograms(sample: str, labels, matrix: np.ndarray, max_depth: int) -> str:
    """Picard MetricsFile text with one shared histogram table (bin column 'depth')."""
    out = ["## htsjdk.samtools.metrics.StringHeader", f"# {sample}", "",
           "## HISTOGRAM\tjava.lang.Integer", "depth\t" + "\t".join(labels)]
    for d in range(max_depth):
        out.append(str(d + 1) + "\t" + "\t".join(_fmt(matrix[i, d]) for i in range(len(labels))))
    return "\n".join(out) + "\n"


def _parse_metrics_histograms(text: str):
    """Returns (sample, {label: np.array(max_depth,)})."""
    lines = text.splitlines()
    sample = None
    i = 0
    labels, rows = None, {}
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("## htsjdk") and i + 1 < len(lines) and lines[i + 1].startswith("# "):
            sample = lines[i + 1][2:].strip()
            i += 2
            continue
        if ln.startswith("## HISTOGRAM"):
            labels = lines[i + 1].split("\t")[1:]
            for j in range(i + 2, len(lines)):
                parts = lines[j].split("\t")
                if len(parts) < 2 or not parts[0].strip() or not parts[0][0].isdigit():
                    break
                rows[int(parts[0])] = [float(x) for x in parts[1:]]
            break
        i += 1
    max_depth = max(rows) if rows else 0
    hists = {lab: np.zeros(max_depth) for lab in (labels or [])}
    for d, vals in rows.items():
        for k, lab in enumerate(labels):
            hists[lab][d - 1] = vals[k]
    return sample, hists


def write_f1r2_targz(counts: F1R2Counts, path: str):
    """Write the CollectF1R2Counts tar.gz (ref/alt histograms + alt table)."""
    ref_labels = ALL_KMERS
    ref_text = _metrics_histograms(counts.sample, ref_labels, counts.ref_hist, counts.max_depth)

    alt_labels, alt_mat = [], []
    for ci, ctx in enumerate(ALL_KMERS):
        mid = BASES.index(ctx[1])
        for a in range(4):
            if a == mid:
                continue
            for o, oname in ((F1R2, "F1R2"), (F2R1, "F2R1")):
                alt_labels.append(f"{ctx}_{BASES[a]}_{oname}")
                alt_mat.append(counts.alt_hist[ci, a, o])
    alt_text = _metrics_histograms(counts.sample, alt_labels, np.array(alt_mat), counts.max_depth)

    tbl = [f"#<METADATA>SAMPLE={counts.sample}",
           "context\tref_count\talt_count\tref_f1r2\talt_f1r2\tdepth\talt"]
    for ctx_i, alt_i, rc, ac, rf, af in counts.alt_rows:
        tbl.append(f"{ALL_KMERS[ctx_i]}\t{rc}\t{ac}\t{rf}\t{af}\t{rc + ac}\t{BASES[alt_i]}")
    tbl_text = "\n".join(tbl) + "\n"

    with tarfile.open(path, "w:gz") as tar:
        for name, text in ((counts.sample + REF_HIST_EXT, ref_text),
                           (counts.sample + ALT_HIST_EXT, alt_text),
                           (counts.sample + ALT_TABLE_EXT, tbl_text)):
            data = text.encode()
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data))


def read_f1r2_targz(path: str, max_depth=DEFAULT_MAX_DEPTH):
    """Read one or more samples' F1R2Counts from a CollectF1R2Counts tar.gz."""
    by_sample = {}
    with tarfile.open(path, "r:gz") as tar:
        members = {m.name: tar.extractfile(m).read().decode() for m in tar if m.isfile()}
    for name, text in members.items():
        if name.endswith(REF_HIST_EXT):
            sample, hists = _parse_metrics_histograms(text)
            c = by_sample.setdefault(sample, F1R2Counts(sample, max_depth))
            for lab, h in hists.items():
                c.ref_hist[KMER_INDEX[lab]][: len(h)] += h
        elif name.endswith(ALT_HIST_EXT):
            sample, hists = _parse_metrics_histograms(text)
            c = by_sample.setdefault(sample, F1R2Counts(sample, max_depth))
            for lab, h in hists.items():
                ctx, alt, orient = lab.split("_")
                c.alt_hist[KMER_INDEX[ctx], BASES.index(alt),
                           F1R2 if orient == "F1R2" else F2R1][: len(h)] += h
        elif name.endswith(ALT_TABLE_EXT):
            sample = None
            rows = []
            for ln in text.splitlines():
                if ln.startswith("#<METADATA>SAMPLE="):
                    sample = ln.split("=", 1)[1]
                    continue
                if ln.startswith("#") or ln.startswith("context") or not ln.strip():
                    continue
                ctx, rc, ac, rf, af, _dp, alt = ln.split("\t")
                rows.append((KMER_INDEX[ctx], BASES.index(alt), int(rc), int(ac),
                             int(rf), int(af)))
            c = by_sample.setdefault(sample, F1R2Counts(sample, max_depth))
            c.alt_rows.extend(rows)
    return by_sample


# ---------------------------------------------------------------------------
# LearnReadOrientationModel (revcomp merge + per-context EM)
# ---------------------------------------------------------------------------

class ArtifactPriorCollection:
    def __init__(self, sample: str):
        self.sample = sample
        self.priors = {k: ArtifactPrior(k, flat_prior(BASES.index(k[1])), 0, 0)
                       for k in ALL_KMERS}

    def set(self, prior: ArtifactPrior):
        self.priors[prior.context] = prior
        rc = prior.reverse_complement()
        self.priors[rc.context] = rc

    def get(self, context: str) -> ArtifactPrior | None:
        return self.priors.get(context)

    def num_unique_contexts(self):
        return sum(1 for p in self.priors.values() if p.num_examples > 0) // 2


def learn_artifact_priors(counts: F1R2Counts,
                          convergence_threshold=DEFAULT_CONVERGENCE_THRESHOLD,
                          max_iterations=DEFAULT_MAX_EM_ITERATIONS) -> ArtifactPriorCollection:
    """Merge revcomp contexts and run the per-context EM
    (LearnReadOrientationModel.doWork:118-175)."""
    D = counts.max_depth
    alt_rows_by_ctx = {}
    for row in counts.alt_rows:
        alt_rows_by_ctx.setdefault(row[0], []).append(row)

    collection = ArtifactPriorCollection(counts.sample)
    for ctx in CANONICAL_KMERS:
        ci = KMER_INDEX[ctx]
        rc = reverse_complement(ctx)
        rci = KMER_INDEX[rc]

        ref_hist = counts.ref_hist[ci] + counts.ref_hist[rci]

        alt_hist = counts.alt_hist[ci].copy()
        # revcomp depth-1 hist folds in with complemented alt and flipped orientation
        for a in range(4):
            ca = 3 - a  # complement index under ACGT ordering (A<->T, C<->G)
            alt_hist[a, F1R2] += counts.alt_hist[rci, ca, F2R1]
            alt_hist[a, F2R1] += counts.alt_hist[rci, ca, F1R2]

        rows = []
        for (_c, ai, rcnt, acnt, rf, af) in alt_rows_by_ctx.get(ci, ()):
            rows.append((ai, acnt, af, rcnt + acnt))
        for (_c, ai, rcnt, acnt, rf, af) in alt_rows_by_ctx.get(rci, ()):
            rows.append((3 - ai, acnt, acnt - af, rcnt + acnt))
        rows = np.array(rows, np.int64).reshape(-1, 4)

        if ref_hist.sum() == 0 or len(rows) == 0:
            continue
        prior = learn_context(ctx, ref_hist, alt_hist, rows, D,
                              convergence_threshold, max_iterations)
        collection.set(prior)
    return collection


PRIOR_COLUMNS = ["context", "rev_comp", "f1r2_a", "f1r2_c", "f1r2_g", "f1r2_t",
                 "f2r1_a", "f2r1_c", "f2r1_g", "f2r1_t", "hom_ref", "germline_het",
                 "somatic_het", "hom_var", "num_examples", "num_alt_examples"]


def write_artifact_priors_targz(collections, path: str):
    """Write the LearnReadOrientationModel output tar.gz of .orientation_priors tables."""
    with tarfile.open(path, "w:gz") as tar:
        for coll in collections:
            lines = [f"#<METADATA>SAMPLE={coll.sample}", "\t".join(PRIOR_COLUMNS)]
            for ctx in ALL_KMERS:
                p = coll.priors[ctx]
                vals = [ctx, reverse_complement(ctx)] + [repr(float(x)) for x in p.pi] + [
                    str(p.num_examples), str(p.num_alt_examples)]
                lines.append("\t".join(vals))
            data = ("\n".join(lines) + "\n").encode()
            ti = tarfile.TarInfo(coll.sample + PRIORS_EXT)
            ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data))


def read_artifact_priors_targz(path: str):
    """Returns {sample: ArtifactPriorCollection}."""
    out = {}
    with tarfile.open(path, "r:gz") as tar:
        for m in tar:
            if not m.isfile() or not m.name.endswith(PRIORS_EXT):
                continue
            text = tar.extractfile(m).read().decode()
            sample = None
            coll = None
            for ln in text.splitlines():
                if ln.startswith("#<METADATA>SAMPLE="):
                    sample = ln.split("=", 1)[1]
                    coll = ArtifactPriorCollection(sample)
                    continue
                if ln.startswith("#") or ln.startswith("context") or not ln.strip():
                    continue
                parts = ln.split("\t")
                ctx = parts[0]
                pi = np.array([float(x) for x in parts[2:14]])
                coll.priors[ctx] = ArtifactPrior(ctx, pi, int(parts[14]), int(parts[15]))
            if coll is not None:
                out[sample] = coll
    return out


# ---------------------------------------------------------------------------
# ReadOrientationFilter (mutect/filtering/ReadOrientationFilter.java)
# ---------------------------------------------------------------------------

def orientation_artifact_probability(collection: ArtifactPriorCollection, context: str,
                                     alt_base: str, f1r2, f2r1, alt_index: int):
    """Posterior probability the variant is an orientation artifact.

    f1r2/f2r1: per-allele F1R2/F2R1 count arrays from the tumor genotype.
    alt_index: index of the scored alt allele (0-based among alts).
    """
    if len(context) != CONTEXT_SIZE or "N" in context:
        return 0.0
    prior = collection.get(context)
    if prior is None or alt_base not in BASES:
        return 0.0
    ref_count = f1r2[0] + f2r1[0]
    alt_f1r2 = f1r2[alt_index + 1]
    alt_f2r1 = f2r1[alt_index + 1]
    alt_count = alt_f1r2 + alt_f2r1
    depth = ref_count + alt_count
    ref_base_idx = BASES.index(context[REF_CONTEXT_PADDING])
    alt_idx = BASES.index(alt_base)
    post = compute_responsibilities(ref_base_idx, alt_idx, alt_count, alt_f1r2, depth,
                                    prior.pi, given_not_hom_ref=True)
    return float(max(post[STATE_INDEX["F1R2_" + alt_base]],
                     post[STATE_INDEX["F2R1_" + alt_base]]))
