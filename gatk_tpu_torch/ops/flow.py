# Copied verbatim from gatk_tpu/ops/flow.py; only import lines may differ.
"""Flow-space read model (Ultima Genomics) — key codec + FlowBasedRead.

TPU-first re-design of the reference's flow-based machinery:
  * utils/read/FlowBasedKeyCodec.java:18-151 (base<->flow-space conversions)
  * utils/read/FlowBasedRead.java:275-398 (flow matrix from quals + tp/t0 tags)
  * utils/haplotype/FlowBasedHaplotype.java (haplotype flow keys)

A flow-based read is re-encoded as a *key*: the homopolymer run length called at
each flow of the cyclic flow order (e.g. "TGCA"). The per-flow error model is a
dense (max_hmer+1, n_flows) probability matrix P(true hmer | called hmer) built
from base quals and the tp (and optionally t0) tags — already the natural layout
for batched device math, so we build it directly as a numpy array.
"""
from __future__ import annotations

import numpy as np

DEFAULT_FLOW_ORDER = "TGCA"
MAX_CLASS = 12  # FlowBasedRead.MAX_CLASS — default maximal hmer tracked
DEFAULT_FILLING_VALUE = 0.001  # FlowBasedArgumentCollection.DEFAULT_FILLING_VALUE
MINIMAL_CALL_PROB = 0.1  # FlowBasedRead.java:46


def base_array_to_key(bases: np.ndarray, flow_order: str) -> np.ndarray:
    """Convert base-space sequence to flow-space key (run length per flow).

    Mirrors FlowBasedKeyCodec.baseArrayToKey (FlowBasedKeyCodec.java:18-49):
    walk the cyclic flow order; at each flow emit the length of the homopolymer
    of that base at the cursor (N matches anything).
    """
    bases = np.asarray(bases, dtype=np.uint8)
    fo = np.frombuffer(flow_order.encode(), dtype=np.uint8)
    period = len(fo)
    out = []
    loc = 0
    flow_n = 0
    guard = 0
    n = len(bases)
    N = ord("N")
    while loc < n:
        fb = fo[flow_n % period]
        if bases[loc] != fb and bases[loc] != N:
            out.append(0)
            guard += 1
            if guard > period:
                raise ValueError(
                    f"base not in flow order {flow_order}: {chr(bases[loc])}")
        else:
            count = 0
            while loc < n and (bases[loc] == fb or bases[loc] == N):
                loc += 1
                count += 1
            out.append(count)
            guard = 0
        flow_n += 1
    return np.asarray(out, dtype=np.int32)


def key_to_base(key: np.ndarray) -> np.ndarray:
    """Index of the last base output before each flow (FlowBasedKeyCodec.java:56-64)."""
    key = np.asarray(key, dtype=np.int64)
    out = np.empty(len(key), dtype=np.int32)
    out[0] = -1
    np.cumsum(key[:-1], out=out[1:], dtype=np.int64)
    out[1:] -= 1
    return out


def flow_to_base(flow_order: str, n: int) -> np.ndarray:
    """Nucleotide read at each of n flows (FlowBasedKeyCodec.java:73-80)."""
    fo = np.frombuffer(flow_order.encode(), dtype=np.uint8)
    return fo[np.arange(n) % len(fo)]


def base_array_to_key_space(bases: np.ndarray, key_len: int, arr: np.ndarray,
                            default: int, flow_order: str) -> np.ndarray:
    """Conform a per-base score array to flow space (FlowBasedKeyCodec.java:122-151):
    min over each homopolymer run; zero-flows copy the previous filled flow
    (default at the head)."""
    bases = np.asarray(bases, dtype=np.uint8)
    arr = np.asarray(arr)
    if len(bases) != len(arr):
        raise ValueError("bases and score array length mismatch")
    fo = np.frombuffer(flow_order.encode(), dtype=np.uint8)
    period = len(fo)
    out = np.empty(key_len, dtype=arr.dtype)
    loc = 0
    flow_n = 0
    last = default
    n = len(bases)
    N = ord("N")
    while loc < n:
        fb = fo[flow_n % period]
        if bases[loc] != fb and bases[loc] != N:
            out[flow_n] = last
        else:
            q = 127
            while loc < n and (bases[loc] == fb or bases[loc] == N):
                q = min(int(arr[loc]), q)
                loc += 1
            out[flow_n] = q
            last = q
        flow_n += 1
    out[flow_n:] = last
    return out


class FlowBasedHaplotype:
    """Haplotype in flow space (utils/haplotype/FlowBasedHaplotype.java)."""

    def __init__(self, bases, flow_order: str = DEFAULT_FLOW_ORDER):
        self.bases = np.frombuffer(bytes(bases), dtype=np.uint8)
        self.flow_order = flow_order
        self.key = base_array_to_key(self.bases, flow_order)
        self.flow2base = key_to_base(self.key)
        self.flow_order_array = flow_to_base(flow_order, len(self.key))

    @property
    def key_length(self) -> int:
        return len(self.key)


class FlowBasedRead:
    """Read in flow space with its error-probability matrix.

    flow_matrix[h, f] = P(true hmer length == h | flow f) for h in 0..max_hmer.
    Construction mirrors FlowBasedRead.readFlowMatrix (FlowBasedRead.java:275-347):
      * fill with per-hmer minimal error prob (filling value, or derived from
        max base qual when filling value == 0)
      * tp tag distributes each base's error prob 10^(-q/10) to hmer call+tp[i]
      * optional t0 tag adds 1->0 error probs on zero flows
      * call prob = max(0.1, 1 - total error) at the called hmer
      * clip: probs <= 3*min filled back down to min (clipProbs, :821-831)
    """

    def __init__(self, bases, quals, flow_order: str = DEFAULT_FLOW_ORDER,
                 tp: np.ndarray | None = None, t0: np.ndarray | None = None,
                 max_hmer: int = MAX_CLASS,
                 filling_value: float = DEFAULT_FILLING_VALUE,
                 ins_quals: np.ndarray | None = None,
                 del_quals: np.ndarray | None = None,
                 gcp: np.ndarray | None = None):
        self.bases = np.frombuffer(bytes(bases), dtype=np.uint8)
        self.quals = np.asarray(quals, dtype=np.uint8)
        self.flow_order = flow_order
        self.max_hmer = int(max_hmer)
        self.key = base_array_to_key(self.bases, flow_order)
        self.flow2base = key_to_base(self.key)
        self.flow_order_array = flow_to_base(flow_order, len(self.key))
        self._ins_quals = ins_quals
        self._del_quals = del_quals
        self._gcp = gcp

        if filling_value > 0:
            per_hmer_min = filling_value
            total_min = filling_value
        else:
            max_q = float(self.quals.max()) if len(self.quals) else 40.0
            if max_q == 0:
                max_q = 40.0
            total_min = 10.0 ** (-max_q / 10.0)
            per_hmer_min = total_min / self.max_hmer
        self.per_hmer_min_error = per_hmer_min

        nf = len(self.key)
        mh = self.max_hmer
        fm = np.full((mh + 1, nf), per_hmer_min, dtype=np.float64)
        probs = np.power(10.0, -self.quals.astype(np.float64) / 10.0)
        use_t0 = t0 is not None
        if use_t0:
            t0 = np.asarray(t0, dtype=np.float64)
            t0probs = np.power(10.0, -t0 / 10.0)
        if tp is None:
            tp = np.zeros(len(self.bases), dtype=np.int8)
        tp = np.asarray(tp, dtype=np.int64)

        qual_ofs = 0
        for f in range(nf):
            run = int(self.key[f])
            if run > 0:
                # parseSingleHmer (FlowBasedRead.java:352-365)
                for i in range(qual_ofs, qual_ofs + run):
                    if tp[i] != 0:
                        loc = max(min(run + int(tp[i]), mh), 0)
                        if fm[loc, f] == per_hmer_min:
                            fm[loc, f] = probs[i]
                        else:
                            fm[loc, f] += probs[i]
            if run == 0 and use_t0:
                # parseZeroQuals (FlowBasedRead.java:373-385)
                if 0 < qual_ofs < len(probs):
                    p0 = min(t0probs[qual_ofs - 1], t0probs[qual_ofs])
                    if p0 <= total_min * 3:
                        p0 = 0.0
                    fm[1, f] = max(fm[1, f], p0)
            total_err = fm[:mh, f].sum()
            fm[min(run, mh), f] = max(MINIMAL_CALL_PROB, 1.0 - total_err)
            qual_ofs += run
        # clipProbs (FlowBasedRead.java:821-831)
        thresh = per_hmer_min * 3
        for h in range(mh):
            mask = (fm[h] <= thresh) & (self.key != h)
            fm[h, mask] = per_hmer_min
        self.flow_matrix = fm

    @property
    def n_flows(self) -> int:
        return len(self.key)

    def get_prob(self, flow: int, hmer: int) -> float:
        """FlowBasedRead.getProb (FlowBasedRead.java:444-449)."""
        p = self.flow_matrix[min(hmer, self.max_hmer), flow]
        return p if 0.0 <= p <= 1.0 else 1.0

    def prob_table(self, max_hap_hmer: int | None = None) -> np.ndarray:
        """(n_flows, H+1) lookup: row f gives get_prob(f, h) for h = 0..H."""
        mh = self.max_hmer if max_hap_hmer is None else max_hap_hmer
        idx = np.minimum(np.arange(mh + 1), self.max_hmer)
        return self.flow_matrix[idx, :].T.copy()

    def key_space_quals(self, default_indel: int = 40, default_gcp: int = 10):
        """Insertion/deletion/gcp quals conformed to flow space
        (FlowBasedPairHMM.java:130-132 with the default no-data fills)."""
        nf = len(self.key)
        iq = self._ins_quals if self._ins_quals is not None else np.full(
            len(self.bases), default_indel, np.uint8)
        dq = self._del_quals if self._del_quals is not None else np.full(
            len(self.bases), default_indel, np.uint8)
        gc = self._gcp if self._gcp is not None else np.full(
            len(self.bases), default_gcp, np.uint8)
        return (
            base_array_to_key_space(self.bases, nf, iq, default_indel, self.flow_order),
            base_array_to_key_space(self.bases, nf, dq, default_indel, self.flow_order),
            base_array_to_key_space(self.bases, nf, gc, default_gcp, self.flow_order),
        )


def flow_read_from_sam(read, flow_order: str = DEFAULT_FLOW_ORDER,
                       max_hmer: int = MAX_CLASS) -> FlowBasedRead:
    """Build a FlowBasedRead from a SAM/BAM record (tp tag = signed byte array,
    t0 tag = FASTQ-encoded string), per FlowBasedRead.java:275-305."""
    tags = getattr(read, "tags", {}) or {}
    tp = tags.get("tp")
    if tp is not None:
        tp = np.asarray(tp, dtype=np.int64)
    t0 = tags.get("t0")
    if isinstance(t0, str):
        t0 = np.frombuffer(t0.encode(), np.uint8).astype(np.int64) - 33
    return FlowBasedRead(read.bases, read.quals, flow_order=flow_order,
                         tp=tp, t0=t0, max_hmer=max_hmer)
