# Copied verbatim from gatk_tpu/funcotator/gencode.py; only import lines may differ.
"""GENCODE datasource: GTF model + transcript sequences + variant classification.

Reference behavior: tools/funcotator/dataSources/gencode/
GencodeFuncotationFactory.java (variant classification against transcripts,
codon/protein change computation from the pc_transcripts FASTA),
FuncotatorUtils.java (coordinate mapping, codon translation),
tools/funcotator/Funcotator.java:717 (datasource config layout:
gencode.config with src_file + gencode_fasta_path).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

CODON_TABLE = {}
_BASES = "TCAG"
_AAS = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")
for _i, _a in enumerate(_BASES):
    for _j, _b in enumerate(_BASES):
        for _k, _c in enumerate(_BASES):
            CODON_TABLE[_a + _b + _c] = _AAS[16 * _i + 4 * _j + _k]

COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(s: str) -> str:
    return s.translate(COMPLEMENT)[::-1]


@dataclass
class Transcript:
    transcript_id: str
    gene_name: str
    contig: str
    strand: str
    start: int  # 1-based inclusive
    end: int
    exons: list = field(default_factory=list)  # [(start, end)] 1-based, genomic order
    cds: list = field(default_factory=list)    # [(start, end)]
    tags: set = field(default_factory=set)
    transcript_type: str = ""
    sequence: str = ""       # spliced transcript sequence (transcript strand)
    cds_range: tuple = None  # (start, end) 1-based inclusive in transcript coords

    @property
    def cds_span(self):
        if not self.cds:
            return None
        return (min(s for s, _ in self.cds), max(e for _, e in self.cds))

    def genomic_to_transcript(self, pos: int):
        """1-based genomic -> 1-based transcript coordinate, or None if intronic."""
        exons = sorted(self.exons)
        offset = 0
        if self.strand == "+":
            for s, e in exons:
                if s <= pos <= e:
                    return offset + (pos - s) + 1
                offset += e - s + 1
        else:
            for s, e in sorted(exons, reverse=True):
                if s <= pos <= e:
                    return offset + (e - pos) + 1
                offset += e - s + 1
        return None

    def exon_number(self, pos: int):
        exons = sorted(self.exons, reverse=self.strand == "-")
        for i, (s, e) in enumerate(exons):
            if s <= pos <= e:
                return i + 1
        return None


def parse_gtf_attributes(s: str) -> dict:
    out = {}
    for item in s.strip().split(";"):
        item = item.strip()
        if not item:
            continue
        if " " in item:
            k, v = item.split(" ", 1)
            out[k] = v.strip().strip('"')
    return out


def load_gtf(path: str):
    """{transcript_id: Transcript} from a GENCODE GTF."""
    transcripts = {}
    with open(path) as fh:
        for ln in fh:
            if ln.startswith("#"):
                continue
            f = ln.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            feature = f[2]
            attrs = parse_gtf_attributes(f[8])
            tid = attrs.get("transcript_id")
            if feature == "transcript":
                transcripts[tid] = Transcript(
                    transcript_id=tid, gene_name=attrs.get("gene_name", ""),
                    contig=f[0], strand=f[6], start=int(f[3]), end=int(f[4]),
                    transcript_type=attrs.get("transcript_type", ""))
                if "tag" in attrs:
                    transcripts[tid].tags.add(attrs["tag"])
            elif feature in ("exon", "CDS") and tid in transcripts:
                t = transcripts[tid]
                span = (int(f[3]), int(f[4]))
                (t.exons if feature == "exon" else t.cds).append(span)
                if "tag" in attrs:
                    t.tags.add(attrs["tag"])
    return transcripts


def load_transcript_fasta(path: str):
    """{transcript_id: (sequence, cds_range)} from a gencode pc_transcripts FASTA."""
    out = {}
    tid = None
    cds = None
    seq = []

    def flush():
        if tid is not None:
            out[tid] = ("".join(seq), cds)

    with open(path) as fh:
        for ln in fh:
            ln = ln.rstrip("\n")
            if ln.startswith(">"):
                flush()
                parts = ln[1:].split("|")
                tid = parts[0]
                cds = None
                for p in parts:
                    if p.startswith("CDS:"):
                        a, b = p[4:].split("-")
                        cds = (int(a), int(b))
                seq = []
            else:
                seq.append(ln)
    flush()
    return out


class GencodeDataSource:
    def __init__(self, transcripts: dict, name="Gencode", version="19", build="hg19"):
        self.transcripts = transcripts
        self.name = name
        self.version = version
        self.build = build
        self._by_contig = {}
        for t in transcripts.values():
            self._by_contig.setdefault(t.contig, []).append(t)
            alias = t.contig[3:] if t.contig.startswith("chr") else "chr" + t.contig
            self._by_contig.setdefault(alias, []).append(t)

    @staticmethod
    def load(ds_dir: str, build: str = None):
        """Load from a funcotator datasource directory (gencode_*/<build>/gencode.config)."""
        config_path = None
        for root, _dirs, files in os.walk(ds_dir):
            if "gencode.config" in files:
                if build is None or os.path.basename(root) == build:
                    config_path = os.path.join(root, "gencode.config")
                    break
        if config_path is None:
            raise FileNotFoundError(f"no gencode.config under {ds_dir}")
        cfg = {}
        with open(config_path) as fh:
            for ln in fh:
                ln = ln.strip()
                if ln.startswith("#") or "=" not in ln:
                    continue
                k, v = ln.split("=", 1)
                cfg[k.strip()] = v.strip()
        base = os.path.dirname(config_path)
        transcripts = load_gtf(os.path.join(base, cfg["src_file"]))
        if cfg.get("gencode_fasta_path"):
            seqs = load_transcript_fasta(os.path.join(base, cfg["gencode_fasta_path"]))
            for tid, t in transcripts.items():
                if tid in seqs:
                    t.sequence, t.cds_range = seqs[tid]
        return GencodeDataSource(transcripts, cfg.get("name", "Gencode"),
                                 cfg.get("version", "19"),
                                 os.path.basename(base))

    def overlapping(self, contig, start1, end1):
        return [t for t in self._by_contig.get(contig, ())
                if t.start <= end1 and t.end >= start1]


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

SPLICE_SITE_WINDOW = 2
FLANK_5P = 5000
FLANK_3P = 0


@dataclass
class Funcotation:
    hugo_symbol: str = ""
    classification: str = "IGR"
    secondary: str = ""
    variant_type: str = "SNP"
    transcript_id: str = ""
    strand: str = ""
    exon: str = ""
    cdna_change: str = ""
    codon_change: str = ""
    protein_change: str = ""


def _variant_type(ref: str, alt: str) -> str:
    if len(ref) == 1 and len(alt) == 1:
        return "SNP"
    if len(ref) == len(alt):
        return {2: "DNP", 3: "TNP"}.get(len(ref), "ONP")
    return "INS" if len(alt) > len(ref) else "DEL"


def classify(contig: str, pos1: int, ref: str, alt: str, ds: GencodeDataSource,
             transcript_mode="CANONICAL", ref_fetch=None) -> Funcotation:
    """Classify one variant against the datasource (best transcript).

    ref_fetch: optional fn(contig, start1, end1) -> genomic bases, enabling
    5'UTR de-novo-start refinement (needs the -R reference)."""
    vt = _variant_type(ref, alt)
    end1 = pos1 + len(ref) - 1
    overlapping = ds.overlapping(contig, pos1, end1)
    if not overlapping:
        flank = [t for t in ds.overlapping(contig, pos1 - FLANK_3P - 1, end1 + FLANK_5P)]
        if flank:
            t = flank[0]
            return Funcotation(hugo_symbol=t.gene_name, classification="FIVE_PRIME_FLANK",
                               variant_type=vt, transcript_id=t.transcript_id,
                               strand=t.strand)
        return Funcotation(variant_type=vt)

    candidates = [(_transcript_rank(t), t) for t in overlapping]
    candidates.sort(key=lambda x: x[0])
    results = [(_classify_in_transcript(t, pos1, ref, alt, vt, ref_fetch), rank, t)
               for rank, t in candidates]
    # best transcript: rank first, then severity of classification
    results.sort(key=lambda x: (x[1], -_severity(x[0].classification)))
    return results[0][0]


def _transcript_rank(t: Transcript):
    rank = 3
    if any(tag.startswith("appris_principal") for tag in t.tags):
        rank = 0
    elif "basic" in t.tags:
        rank = 1
    elif t.transcript_type == "protein_coding":
        rank = 2
    return (rank, -(t.end - t.start))


# GencodeFuncotation.VariantClassification severities (:777-849); LOWER is
# more severe in the reference — _severity negates so callers keep max=worst
_REF_SEVERITY = {
    "COULD_NOT_DETERMINE": 99, "INTRON": 10, "FIVE_PRIME_UTR": 6,
    "THREE_PRIME_UTR": 6, "IGR": 20, "FIVE_PRIME_FLANK": 15,
    "THREE_PRIME_FLANK": 16, "MISSENSE": 1, "NONSENSE": 0, "NONSTOP": 0,
    "SILENT": 5, "SPLICE_SITE": 4, "IN_FRAME_DEL": 1, "IN_FRAME_INS": 1,
    "FRAME_SHIFT_INS": 2, "FRAME_SHIFT_DEL": 2, "START_CODON_SNP": 3,
    "START_CODON_INS": 3, "START_CODON_DEL": 3, "DE_NOVO_START_IN_FRAME": 1,
    "DE_NOVO_START_OUT_FRAME": 0, "RNA": 4, "LINCRNA": 4,
}


def _severity(c):
    return -_REF_SEVERITY.get(c, 99)


def _changed_interval(pos1: int, ref: str, alt: str):
    """1-based inclusive genomic interval of the actually-changed bases
    (GencodeFuncotationFactory.getBasesChangedIntervalIgnoringLeadingVcfContextBase:
    common-prefix-trimmed; for insertions the inserted length extends the end)."""
    if len(ref) == len(alt):
        return (pos1, pos1 + len(ref) - 1)
    k = 0
    while k < min(len(ref), len(alt)) and ref[k] == alt[k]:
        k += 1
    adj = pos1 + k
    if len(alt) > len(ref):  # insertion
        return (adj, pos1 + len(ref) - 1 + (len(alt) - k))
    return (adj, pos1 + len(ref) - 1)


def _splice_site_exact(t: Transcript, pos1: int, ref: str, alt: str) -> bool:
    """GencodeFuncotationFactory.createVariantClassification splice window:
    per-exon side intervals [start-w, start+w-1] / [end-w+1, end+w] (w=2),
    terminal exons checked on the transcript-internal side only, exon loci
    shifted right past an insertion point (adjustLocusForInsertion)."""
    c0, c1 = _changed_interval(pos1, ref, alt)
    is_ins = len(alt) > len(ref)
    ins_len = c1 - c0 + 1 if is_ins else 0
    w = SPLICE_SITE_WINDOW
    exons = sorted(t.exons)
    n = len(exons)
    for gi, (s, e) in enumerate(exons):
        exon_no = gi + 1 if t.strand == "+" else n - gi
        internal = exon_no != 1 and exon_no != n
        do_left = internal or (t.strand == "-" and exon_no == 1) or \
            (t.strand == "+" and exon_no == n)
        do_right = internal or (t.strand == "+" and exon_no == 1) or \
            (t.strand == "-" and exon_no == n)
        s_adj = s + ins_len if (is_ins and s > c0) else s
        e_adj = e + ins_len if (is_ins and e > c0) else e
        if do_left and c0 <= s_adj + w - 1 and c1 >= s_adj - w:
            return True
        if do_right and c0 <= e_adj + w and c1 >= e_adj - w + 1:
            return True
    return False


def _intron_splice_notation(t: Transcript, pos1: int, ref: str, alt: str) -> str:
    """FuncotatorUtils.createSpliceSiteCodonChange: c.e{exon}{+/-}{dist} for
    intronic splice-site variants (distance from the nearest exon boundary;
    deletions use the first changed base)."""
    start = pos1 if len(alt) >= len(ref) else _changed_interval(pos1, ref, alt)[0]
    exons = sorted(t.exons)
    n = len(exons)
    best = None
    for gi, (s, e) in enumerate(exons):
        exon_no = gi + 1 if t.strand == "+" else n - gi
        for boundary in (s, e):
            d = start - boundary
            if best is None or abs(d) < abs(best[0]):
                best = (d, exon_no)
    if best is None:
        return ""
    d, exon_no = best
    if t.strand == "-":
        d = -d
    return f"c.e{exon_no}{'+' if d >= 0 else '-'}{abs(d)}"


def _de_novo_start(t: Transcript, pos1: int, ref: str, alt: str,
                   cds_start: int, ref_fetch):
    """DE_NOVO_START_{IN,OUT}_FRAME detection for 5'UTR variants
    (GencodeFuncotationFactory.createUtrFuncotation:1700-1755): build the
    strand-corrected alt subsequence (2 leading bases + alt + trailing bases),
    scan it for an ATG, and frame-check the hit against the end of the 5'UTR
    sequence. Offsets replicate the reference exactly, including its
    window-index arithmetic for indels. Returns a classification or None."""
    W = 10  # referenceWindow (GencodeFuncotationFactory:104)
    LEAD = 2  # numLeadingBasesForUtrAnnotationSequenceConstruction (:84)
    reflen = len(ref)
    is_indel = reflen != len(alt)
    num_extra = 3 if reflen < 3 else reflen + 1
    indel_adj = 1 if is_indel else 0
    g0 = pos1 - W + indel_adj
    g1 = pos1 + reflen - 1 + W
    if g0 < 1:
        g0 = 1
    try:
        bases = ref_fetch(t.contig, g0, g1).upper()
    except Exception:
        return None
    if len(bases) < g1 - g0 + 1:
        bases = bases + "N" * (g1 - g0 + 1 - len(bases))
    if t.strand == "+":
        s = bases
        front_off, back_off = indel_adj, 0
        sc_alt = alt.upper()
    else:
        s = revcomp(bases)
        front_off, back_off = 0, indel_adj
        sc_alt = revcomp(alt.upper())
    raw = (s[W - LEAD + front_off:W] + sc_alt
           + s[W + reflen:W + num_extra + back_off])
    hit = None
    for i in range(len(raw)):
        if i + 3 >= len(raw):  # reference loop bound is strict (:1738)
            break
        if raw[i:i + 3] == "ATG":
            hit = i
            break
    if hit is None:
        return None
    coding_region_offset = front_off - LEAD + hit
    # position of the variant start (strand-corrected) in transcript coords
    gpos = pos1 if t.strand == "+" else pos1 + reflen - 1
    coding_start = t.genomic_to_transcript(gpos)
    if coding_start is None:
        return None
    utr5_len = cds_start - 1
    region_len = (utr5_len + num_extra) if utr5_len > 0 else 0
    x = coding_start + coding_region_offset
    in_frame = ((region_len - x + 1) % 3) == 0
    return "DE_NOVO_START_IN_FRAME" if in_frame else "DE_NOVO_START_OUT_FRAME"


def _classify_in_transcript(t: Transcript, pos1: int, ref: str, alt: str, vt,
                            ref_fetch=None) -> Funcotation:
    out = Funcotation(hugo_symbol=t.gene_name, variant_type=vt,
                      transcript_id=t.transcript_id, strand=t.strand)
    if t.transcript_type and t.transcript_type != "protein_coding":
        out.classification = "RNA" if t.transcript_type != "lincRNA" else "LINCRNA"
        return out

    tpos = t.genomic_to_transcript(pos1)
    splice = _splice_site_exact(t, pos1, ref, alt)
    if tpos is None or (vt in ("INS", "DEL")
                        and t.genomic_to_transcript(_changed_interval(pos1, ref, alt)[0]) is None):
        if vt in ("INS", "DEL"):
            # intronic indels: splice iff the variant span (anchor for
            # insertions, changed bases for deletions) is within the window
            # of an exon boundary
            if vt == "INS":
                span = (pos1, pos1 + len(ref) - 1)
            else:
                span = _changed_interval(pos1, ref, alt)
            splice = any(
                span[0] <= b + SPLICE_SITE_WINDOW and span[1] >= b - SPLICE_SITE_WINDOW
                for s0, e0 in t.exons for b in (s0, e0))
        out.classification = "SPLICE_SITE" if splice else "INTRON"
        if splice:
            out.secondary = "INTRON"
            out.codon_change = _intron_splice_notation(t, pos1, ref, alt)
        return out

    exon_no = t.exon_number(pos1)
    if exon_no is not None:
        out.exon = str(exon_no)

    cds_range = t.cds_range
    if cds_range is None and t.cds:
        # derive transcript-coordinate CDS range from genomic CDS features
        span = t.cds_span
        a = t.genomic_to_transcript(span[0])
        b = t.genomic_to_transcript(span[1])
        if a is not None and b is not None:
            cds_range = (min(a, b), max(a, b))
    if cds_range is None:
        out.classification = "SPLICE_SITE" if splice else "RNA"
        return out

    cds_start, cds_end = cds_range
    if tpos < cds_start:
        out.classification = "SPLICE_SITE" if splice else "FIVE_PRIME_UTR"
        if out.classification == "FIVE_PRIME_UTR" and t.sequence and \
                ref_fetch is not None:
            dn = _de_novo_start(t, pos1, ref, alt, cds_start, ref_fetch)
            if dn:
                out.classification = dn
        return out
    if tpos > cds_end:
        out.classification = "SPLICE_SITE" if splice else "THREE_PRIME_UTR"
        return out

    # coding
    cds_pos = tpos - cds_start + 1  # 1-based within CDS
    if vt in ("INS", "DEL"):
        return _annotate_coding_indel(t, pos1, ref, alt, vt, out, cds_start,
                                      cds_end, splice)

    if not t.sequence:
        out.classification = "SPLICE_SITE" if splice else "MISSENSE"
        return out

    # SNP/MNP protein change from the transcript sequence
    t_ref = ref if t.strand == "+" else revcomp(ref)
    t_alt = alt if t.strand == "+" else revcomp(alt)
    n = len(t_ref)
    t_start = tpos if t.strand == "+" else tpos - n + 1

    codon_index = (t_start - cds_start) // 3  # 0-based codon
    codon_offset = (t_start - cds_start) % 3
    c0 = cds_start + codon_index * 3 - 1  # 0-based codon start in transcript
    n_codons = (codon_offset + n + 2) // 3
    ref_codons = t.sequence[c0: c0 + 3 * n_codons].upper()
    if len(ref_codons) < 3 * n_codons:
        out.classification = "SPLICE_SITE" if splice else "NONSTOP"
        return out
    alt_codons = (ref_codons[:codon_offset] + t_alt.upper()
                  + ref_codons[codon_offset + n:])
    ref_aa = "".join(CODON_TABLE.get(ref_codons[i:i + 3], "X")
                     for i in range(0, len(ref_codons), 3))
    alt_aa = "".join(CODON_TABLE.get(alt_codons[i:i + 3], "X")
                     for i in range(0, len(alt_codons), 3))
    aa_pos = codon_index + 1

    def _case_marked(codons):
        # oncotator convention: changed positions uppercase, context lowercase
        out_chars = []
        for i, ch in enumerate(codons):
            changed = codon_offset <= i < codon_offset + n
            out_chars.append(ch.upper() if changed else ch.lower())
        return "".join(out_chars)

    out.cdna_change = f"c.{cds_pos}{t_ref.upper()}>{t_alt.upper()}"
    out.codon_change = (f"c.({codon_index * 3 + 1}-{codon_index * 3 + 3 * n_codons})"
                        f"{_case_marked(ref_codons)}>{_case_marked(alt_codons)}")
    out.protein_change = f"p.{ref_aa}{aa_pos}{alt_aa}"

    if aa_pos == 1 and ref_aa != alt_aa:
        out.classification = "START_CODON_SNP"
    elif ref_aa == alt_aa:
        out.classification = "SILENT"
    elif "*" in alt_aa and "*" not in ref_aa:
        out.classification = "NONSENSE"
    elif "*" in ref_aa and "*" not in alt_aa:
        out.classification = "NONSTOP"
    else:
        out.classification = "MISSENSE"
    if splice:
        out.secondary = out.classification
        out.classification = "SPLICE_SITE"
    return out


def _annotate_coding_indel(t: Transcript, pos1: int, ref: str, alt: str, vt,
                           out: Funcotation, cds_start: int, cds_end: int,
                           splice: bool) -> Funcotation:
    """Coding indel annotation: cDNA / codon / protein change strings per
    FuncotatorUtils.getCodingSequenceChangeString, getCodonChangeString (with
    the leading-base frame adjustments) and ProteinChangeInfo (between-codon
    detection, naive-then-trim simplification)."""
    is_ins = vt == "INS"
    is_fs = abs(len(alt) - len(ref)) % 3 != 0
    out.classification = (("FRAME_SHIFT_INS" if is_fs else "IN_FRAME_INS") if is_ins
                          else ("FRAME_SHIFT_DEL" if is_fs else "IN_FRAME_DEL"))
    if splice:
        out.secondary = out.classification
        out.classification = "SPLICE_SITE"

    # common-prefix trim -> changed bases
    k = 0
    while k < min(len(ref), len(alt)) and ref[k] == alt[k]:
        k += 1
    changed = (alt[k:] if is_ins else ref[k:])

    def cdsp(g):
        tp = t.genomic_to_transcript(g)
        return None if tp is None else tp - cds_start + 1

    minus = t.strand == "-"
    changed_t = revcomp(changed) if minus else changed

    if is_ins:
        # insertion sits between genomic pos1+k-1 and pos1+k; in transcript
        # orientation: between n and n+1
        flank_a = cdsp(pos1 + k - 1)
        flank_b = cdsp(pos1 + k) if (pos1 + k) <= t.end else None
        cands = [p for p in (flank_a, flank_b) if p is not None]
        if not cands:
            return out
        n = min(cands) if len(cands) == 2 else (cands[0] if not minus else cands[0] - 1)
        out.cdna_change = f"c.{n}_{n + 1}ins{changed_t}"
        d0 = d1 = None
    else:
        a = cdsp(pos1 + k)
        b = cdsp(pos1 + len(ref) - 1)
        if a is None and b is None:
            return out
        if a is None:
            a = 1
        if b is None:
            b = cds_end - cds_start + 1
        d0, d1 = (min(a, b), max(a, b))
        if len(changed_t) == 1:
            out.cdna_change = f"c.{d0}del{changed_t}"
        else:
            out.cdna_change = f"c.{d0}_{d1}del{changed_t}"

    if not t.sequence:
        return out
    coding = t.sequence[cds_start - 1: cds_end].upper()

    def codon_start(p):
        return 3 * ((p - 1) // 3) + 1

    def codon_end(p):
        return 3 * ((p + 2) // 3)

    anchor = (cdsp(pos1) if not minus else cdsp(pos1 + len(ref) - 1))
    if anchor is None:
        anchor = d0 - 1 if d0 is not None else 1

    if is_ins:
        p = n  # cds position of the base before the insertion point
        # empirical GATK window (getCodonChangeStringForFrameShifts +
        # aligned-allele handling, verified against the PIK3CA indel golden):
        m = p % 3
        if m == 1:
            x, y = p, p + 2
        elif m == 2:
            x, y = codon_start(p), codon_start(p) + 5
        else:
            x, y = p + 1, p + 3
        window = coding[x - 1: y].lower()
        if is_fs and not splice:
            out.codon_change = f"c.({x}-{y}){window}fs"
        else:
            off = p - x + 1 if p >= x else 0
            out.codon_change = (f"c.({x}-{y}){window}>"
                                f"{window[:off]}{changed_t.upper()}{window[off:]}")
    else:
        aligned_del = d0 % 3 == 1 and (d1 - d0 + 1) % 3 == 0
        if is_fs and not splice:
            # fs window: aligned over the FULL ref allele (incl. anchor), with
            # the leading-codon skip when the anchor closes a codon
            # (FuncotatorUtils.getCodonChangeStringForFrameShifts)
            ax = codon_start(anchor if anchor >= 1 else d0)
            ay = codon_end(d1)
            window = coding[ax - 1: ay].lower()
            if anchor >= 1 and anchor % 3 == 0 and not minus:
                ax += 3
                window = window[3:]
            elif minus and (anchor % 3 == 0):
                ay -= 3
                window = window[:-3]
            out.codon_change = f"c.({ax}-{ay}){window}fs"
        elif aligned_del and not splice:
            out.codon_change = f"c.({d0}-{d1}){changed_t.lower()}del"
        else:
            # substitution form: window aligned over the DELETED bases
            ax = codon_start(d0)
            ay = codon_end(d1)
            window = coding[ax - 1: ay].lower()
            kept = [window[i] for i in range(len(window))
                    if not (d0 <= ax + i <= d1)]
            out.codon_change = f"c.({ax}-{ay}){window}>{''.join(kept)}"

    # ---- protein change (ProteinChangeInfo port) ----
    alt_anchor_cds = anchor if anchor >= 1 else 1
    ref_t = revcomp(ref) if minus else ref
    alt_t = revcomp(alt) if minus else alt
    alt_coding = (coding[: alt_anchor_cds - 1] + alt_t.upper()
                  + coding[alt_anchor_cds - 1 + len(ref_t):])

    def translate(seq):
        aas = []
        for i in range(0, len(seq) - 2, 3):
            aa = CODON_TABLE.get(seq[i:i + 3], "?")
            aas.append(aa)
        return "".join(aas)

    ref_prot = translate(coding)
    alt_prot = translate(alt_coding)
    if is_fs:
        idx = (codon_start(alt_anchor_cds) - 1) // 3
        for i in range(max(len(ref_prot), len(alt_prot))):
            if (i >= len(ref_prot) or i >= len(alt_prot)
                    or ref_prot[i] != alt_prot[i]):
                idx = i
                break
        if idx < len(ref_prot):
            out.protein_change = f"p.{ref_prot[idx]}{idx + 1}fs"
        else:
            out.protein_change = f"p.{ref_prot[-1]}{len(ref_prot)}fs"
        return out

    aligned_start = codon_start(alt_anchor_cds)
    codon_offset = alt_anchor_cds - aligned_start
    between = (codon_offset + len(ref_t)) % 3 == 0 if not is_ins else \
        (codon_offset + len(ref_t)) % 3 == 0
    n_alt_aa = (len(alt_t) - 1 + 2) // 3 if len(alt_t) > 1 else 0
    n_ref_aa = (len(ref_t) - 1 + 2) // 3 if len(ref_t) > 1 else 0
    pcsi = (aligned_start - 1) // 3
    for i in range(max(len(ref_prot), len(alt_prot))):
        if (i >= len(ref_prot) or i >= len(alt_prot)
                or ref_prot[i] != alt_prot[i]):
            pcsi = i
            break
    if is_ins:
        if between:
            aa_start = (aligned_start - 1) // 3 + (0 if minus else 1)
            aa_end = aa_start + 1
            ref_aa = ""
            alt_aa = alt_prot[pcsi: min(pcsi + n_alt_aa, len(alt_prot))]
        else:
            p0 = (aligned_start - 1) // 3
            aa_start = p0 + 1
            aa_end = aa_start + n_ref_aa
            ref_aa = ref_prot[p0: aa_end]
            alt_aa = alt_prot[p0: min(aa_start + n_alt_aa, len(alt_prot))]
            aa_start, aa_end, ref_aa, alt_aa = _trim_ins(aa_start, aa_end,
                                                         ref_aa, alt_aa)
        if aa_start == aa_end:
            out.protein_change = f"p.{ref_aa}{aa_start}{alt_aa}"
        elif not ref_aa:
            out.protein_change = f"p.{aa_start}_{aa_end}ins{alt_aa}"
        else:
            out.protein_change = f"p.{aa_start}_{aa_end}{ref_aa}>{alt_aa}"
    else:
        if between:
            p0 = (aligned_start - 1) // 3 + (0 if minus else 1)
            aa_start = p0 + 1
            aa_end = aa_start + n_ref_aa - 1
            ref_aa = ref_prot[p0: min(p0 + n_ref_aa, len(ref_prot))]
            alt_aa = ""
        else:
            p0 = (aligned_start - 1) // 3
            end_off = 0 if minus else 1
            aa_start = p0 + 1
            aa_end = aa_start + n_ref_aa + end_off
            ref_aa = ref_prot[p0: min(aa_end, len(ref_prot))]
            alt_aa = alt_prot[p0: min(aa_start + n_alt_aa + end_off, len(alt_prot))]
            aa_start, aa_end, ref_aa, alt_aa = _trim_del(aa_start, aa_end,
                                                         ref_aa, alt_aa)
        if not alt_aa:
            aa_end = aa_start
        if aa_start != aa_end:
            out.protein_change = f"p.{aa_start}_{aa_end}{ref_aa}>{alt_aa}"
        else:
            out.protein_change = f"p.{ref_aa}{aa_start}del"
    return out


def _trim_del(aa_start, aa_end, ref_aa, alt_aa):
    """ProteinChangeInfo.trimDeletionProteinChangeVariables."""
    front = bool(ref_aa) and bool(alt_aa) and ref_aa[0] == alt_aa[0]
    back = True
    while front or back:
        if front:
            aa_start += 1
            aa_end = aa_start
            ref_aa = ref_aa[1:]
            alt_aa = alt_aa[1:]
        back = bool(alt_aa) and bool(ref_aa) and ref_aa[-1] == alt_aa[-1]
        if back:
            aa_end -= 1
            ref_aa = ref_aa[:-1]
            alt_aa = alt_aa[:-1]
        front = bool(ref_aa) and bool(alt_aa) and ref_aa[0] == alt_aa[0]
    return aa_start, aa_end, ref_aa, alt_aa


def _trim_ins(aa_start, aa_end, ref_aa, alt_aa):
    """ProteinChangeInfo.trimInsertionProteinChangeVariables."""
    front = bool(ref_aa) and bool(alt_aa) and ref_aa[0] == alt_aa[0]
    back = True
    while front or back:
        if front:
            aa_end += 1
            ref_aa = ref_aa[1:]
            alt_aa = alt_aa[1:]
        back = bool(ref_aa) and bool(alt_aa) and ref_aa[-1] == alt_aa[-1]
        if back:
            if aa_start == aa_end:
                aa_start -= 1
            else:
                aa_end -= 1
            ref_aa = ref_aa[:-1]
            alt_aa = alt_aa[:-1]
        front = bool(ref_aa) and bool(alt_aa) and ref_aa[0] == alt_aa[0]
    return aa_start, aa_end, ref_aa, alt_aa
