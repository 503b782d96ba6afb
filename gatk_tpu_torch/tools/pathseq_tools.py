# Copied verbatim from gatk_tpu/tools/pathseq_tools.py; only import lines may differ.
"""PathSeq: microbial read classification.

Reference: tools/spark/pathseq/ — PathSeqBuildKmers.java (host reference →
canonicalized masked kmer set, PSKmerSet/PSKmerUtils), PathSeqFilterSpark.java
(quality + DUST low-complexity masking + host kmer subtraction, PSFilter.java),
PathSeqScoreSpark.java (alignment hits → taxonomic abundance scores with tree
propagation and per-kingdom normalization, PSScorer.java:283-360, PSTree.java).

Re-architecture notes (cited reductions): the Spark RDD pipeline collapses to
vectorized numpy over read batches — kmer membership is np.searchsorted against
a sorted uint64 array (the Hopscotch-set equivalent), which XLA/TPU-style
batches trivially. The bwa-mem host/pathogen alignment stages (PSBwaAligner)
have no in-repo equivalent (bwa is a JNI binary in the reference too); host
subtraction is kmer-based and pathogen assignment reads an aligned BAM, as the
reference's scorer does.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..cli import register_tool

KMER_SIZE_DEFAULT = 31

_BASE_CODE = np.full(256, 255, np.uint8)
for i, b in enumerate(b"ACGT"):
    _BASE_CODE[b] = i
    _BASE_CODE[b + 32] = i


def _canonical_kmers(seq: np.ndarray, k: int) -> np.ndarray:
    """Canonicalized (min of kmer, revcomp) 2-bit packed kmers as uint64,
    excluding windows containing non-ACGT (PSKmerCollection.canonicalizeAndMask)."""
    codes = _BASE_CODE[seq]
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    valid = codes != 255
    ok = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)
    win = np.lib.stride_tricks.sliding_window_view(codes, k).astype(np.uint64)
    weights_fwd = (np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64))
    fwd = (win * weights_fwd[None, :]).sum(axis=1)
    rc_codes = np.uint64(3) - win[:, ::-1]
    rev = (rc_codes * weights_fwd[None, :]).sum(axis=1)
    canon = np.minimum(fwd, rev)
    return canon[ok]


def _read_kmer_hits(bases: np.ndarray, k: int, kmer_set: np.ndarray) -> int:
    kmers = _canonical_kmers(bases, k)
    if kmers.size == 0:
        return 0
    idx = np.searchsorted(kmer_set, kmers)
    idx = np.minimum(idx, len(kmer_set) - 1)
    return int(np.count_nonzero(kmer_set[idx] == kmers)) if len(kmer_set) else 0


def dust_mask(bases: np.ndarray, quals: np.ndarray, window: int = 64,
              t_score: float = 20.0, mask_qual: int = 2) -> np.ndarray:
    """DUST low-complexity masking (PSFilter.doDustMasking / DUSTReadTransformer):
    set base quals to mask_qual inside low-complexity windows scored by
    triplet-frequency: score = sum c_t(c_t-1)/2 / (w-3)."""
    n = len(bases)
    if n < 3:
        return quals
    codes = _BASE_CODE[bases]
    trip = codes[:-2].astype(np.int32) * 16 + codes[1:-1] * 4 + codes[2:]
    trip[(codes[:-2] == 255) | (codes[1:-1] == 255) | (codes[2:] == 255)] = -1
    out = quals.copy()
    for start in range(0, n, window):
        end = min(start + window, n)
        t = trip[start:max(start, end - 2)]
        t = t[t >= 0]
        if len(t) < 4:
            continue
        counts = np.bincount(t, minlength=64)
        score = float((counts * (counts - 1) // 2).sum()) / max(len(t) - 1, 1)
        if score > t_score:
            out[start:end] = mask_qual
    return out


@register_tool("PathSeqBuildKmers")
def pathseq_build_kmers(argv):
    """Build the host-reference kmer library (PathSeqBuildKmers.java)."""
    from ..io import fasta

    p = argparse.ArgumentParser(description="PathSeqBuildKmers")
    p.add_argument("--reference", "-R", required=True)
    p.add_argument("-O", "--output", required=True, help=".npz kmer library")
    p.add_argument("--kmer-size", type=int, default=KMER_SIZE_DEFAULT)
    args = p.parse_args(argv)

    ref = fasta.FastaReference(args.reference)
    all_kmers = []
    for name in ref.index:
        seq = ref.fetch(name)
        all_kmers.append(_canonical_kmers(seq, args.kmer_size))
    kmers = np.unique(np.concatenate(all_kmers)) if all_kmers else np.zeros(0, np.uint64)
    np.savez_compressed(args.output, kmers=kmers, kmer_size=args.kmer_size)
    print(f"kmer library: {len(kmers)} unique canonical {args.kmer_size}-mers -> {args.output}")
    return 0


@register_tool("PathSeqFilter")
def pathseq_filter(argv):
    """Subtract host reads and low-quality/low-complexity sequence
    (PathSeqFilterSpark.java / PSFilter.java stages: quality trim, DUST,
    host kmer subtraction)."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="PathSeqFilter")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--paired-output", required=True)
    p.add_argument("--unpaired-output", default=None)
    p.add_argument("--kmer-file", required=True)
    p.add_argument("--filter-min-kmer-count", type=int, default=1)  # PSFilterArgumentCollection:minKmerCount
    p.add_argument("--min-clipped-read-length", type=int, default=31)
    p.add_argument("--dust-window", type=int, default=64)
    p.add_argument("--dust-t", type=float, default=20.0)
    p.add_argument("--dust-mask-quality", type=int, default=2)
    p.add_argument("--min-base-quality", type=int, default=15)
    p.add_argument("--max-masked-bases", type=float, default=0.05,
                   help="fraction of ambiguous/masked bases allowed (filterAmbiguous)")
    args = p.parse_args(argv)

    lib = np.load(args.kmer_file)
    kmer_set = np.sort(lib["kmers"])
    k = int(lib["kmer_size"])

    reader = bamio.BamReader(args.input)
    kept_by_name: dict[str, list] = {}
    n_in = n_host = n_lowq = 0
    for r in reader:
        if r.is_secondary or r.is_supplementary or r.is_duplicate:
            continue
        n_in += 1
        quals = dust_mask(r.bases, r.quals, args.dust_window, args.dust_t,
                          args.dust_mask_quality)
        masked = int(np.count_nonzero(quals < args.min_base_quality))
        if len(r.bases) < args.min_clipped_read_length or \
                masked > args.max_masked_bases * len(r.bases):
            n_lowq += 1
            continue
        if _read_kmer_hits(r.bases, k, kmer_set) >= args.filter_min_kmer_count:
            n_host += 1
            continue
        kept_by_name.setdefault(r.name, []).append(r)

    paired, unpaired = [], []
    for name, group in kept_by_name.items():
        (paired if len(group) == 2 else unpaired).extend(group)
    w = bamio.BamWriter(args.paired_output, reader.header)
    for r in paired:
        w.write(r)
    w.close()
    if args.unpaired_output:
        w2 = bamio.BamWriter(args.unpaired_output, reader.header)
        for r in unpaired:
            w2.write(r)
        w2.close()
    print(f"{n_in} reads in; {n_host} host-subtracted, {n_lowq} low quality/complexity; "
          f"{len(paired)} paired + {len(unpaired)} unpaired kept")
    return 0


def read_taxonomy(path: str):
    """tax_id\tparent_id\trank\tname\t[length]\t[accessions,...] per line."""
    nodes = {}
    accession_to_tax = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            tax_id, parent = int(parts[0]), int(parts[1])
            rank, name = parts[2], parts[3]
            length = int(parts[4]) if len(parts) > 4 and parts[4] else 0
            nodes[tax_id] = {"parent": parent, "rank": rank, "name": name,
                             "length": length}
            if len(parts) > 5 and parts[5]:
                for acc in parts[5].split(","):
                    accession_to_tax[acc] = tax_id
    return nodes, accession_to_tax


def _path_to_root(nodes, tax_id):
    path = []
    seen = set()
    while tax_id in nodes and tax_id not in seen:
        path.append(tax_id)
        seen.add(tax_id)
        parent = nodes[tax_id]["parent"]
        if parent == tax_id:
            break
        tax_id = parent
    return path


@register_tool("PathSeqScore")
def pathseq_score(argv):
    """Taxonomic abundance scores from pathogen-aligned reads
    (PathSeqScoreSpark.java / PSScorer.computeTaxScores :283-360): each read's
    hits map to taxa via the alignment contig; a read hitting one taxon adds 1
    to 'unambiguous', reads hitting N taxa add 1/N to each; scores propagate
    up the taxonomy to the root and normalize to percent within kingdom."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="PathSeqScore")
    p.add_argument("--paired-input", default=None)
    p.add_argument("--unpaired-input", default=None)
    p.add_argument("--taxonomy-file", required=True)
    p.add_argument("--scores-output", "-O", required=True)
    p.add_argument("--min-score-identity", type=float, default=0.9)
    p.add_argument("--divide-by-genome-length", action="store_true")
    args = p.parse_args(argv)

    nodes, acc_to_tax = read_taxonomy(args.taxonomy_file)

    def hits_for(path):
        reader = bamio.BamReader(path)
        contigs = [s.name for s in reader.header.sequences]
        by_template: dict[str, set] = {}
        for r in reader:
            if r.is_unmapped or r.ref_id < 0:
                continue
            # identity filter: matched bases / read length
            matched = sum(int(l) for o, l in zip(r.cigar_ops, r.cigar_lens)
                          if int(o) in (0, 7))
            if matched < args.min_score_identity * len(r.bases):
                continue
            acc = contigs[r.ref_id]
            tax = acc_to_tax.get(acc)
            if tax is not None:
                by_template.setdefault(r.name, set()).add(tax)
        return by_template

    scores: dict[int, dict] = {}

    def bump(tax_id, key, val):
        s = scores.setdefault(tax_id, {"self_score": 0.0, "score": 0.0,
                                       "reads": 0, "unambiguous": 0})
        s[key] += val

    total_templates = 0
    for path in (args.paired_input, args.unpaired_input):
        if not path:
            continue
        for name, taxa in hits_for(path).items():
            total_templates += 1
            n = len(taxa)
            for t in taxa:
                w = 1.0 / n
                if args.divide_by_genome_length and nodes.get(t, {}).get("length"):
                    w = w * 1e6 / nodes[t]["length"]
                bump(t, "self_score", w)
                bump(t, "reads", 1)
                if n == 1:
                    bump(t, "unambiguous", 1)

    # propagate self scores to ancestors (PSScorer: scores are cumulative up the tree)
    for tax_id in list(scores):
        s = scores[tax_id]["self_score"]
        for anc in _path_to_root(nodes, tax_id):
            bump(anc, "score", s)

    # normalized: percent of the summed root score (per-kingdom in the reference;
    # single-kingdom taxonomies normalize over the whole tree)
    roots = [t for t in scores if nodes.get(t, {}).get("parent", t) == t or
             nodes.get(t, {}).get("rank") == "root"]
    total = sum(scores[r]["score"] for r in roots) or \
        sum(s["self_score"] for s in scores.values()) or 1.0

    with open(args.scores_output, "w") as fh:
        fh.write("tax_id\trank\tname\tscore\tscore_normalized\treads\tunambiguous\treference_length\n")
        for tax_id in sorted(scores):
            node = nodes.get(tax_id, {"rank": "?", "name": "?", "length": 0})
            s = scores[tax_id]
            fh.write(f"{tax_id}\t{node['rank']}\t{node['name']}\t{s['score']:.4f}\t"
                     f"{100.0 * s['score'] / total:.4f}\t{s['reads']}\t"
                     f"{s['unambiguous']}\t{node['length']}\n")
    print(f"scored {total_templates} templates across {len(scores)} taxa -> {args.scores_output}")
    return 0


@register_tool("PathSeqAlign")
def pathseq_align(argv):
    """Align filtered reads to the microbe reference (PathSeqAlignSpark.java /
    PSBwaAligner: bwa-mem stage; here the from-scratch seed-and-extend aligner,
    gatk_tpu/align/seed_extend.py). Output BAM feeds PathSeqScore."""
    from ..align.seed_extend import SeedExtendAligner, revcomp
    from ..io import bam as bamio
    from ..io import fasta, sam as samio

    p = argparse.ArgumentParser(description="PathSeqAlign")
    p.add_argument("-I", "--input", required=True, help="filtered reads BAM")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--microbe-fasta", required=True)
    p.add_argument("--seed-length", type=int, default=21)
    p.add_argument("--min-score-fraction", type=float, default=0.5)
    args = p.parse_args(argv)

    ref = fasta.FastaReference(args.microbe_fasta)
    contigs = [(name, ref.fetch(name)) for name in ref.contigs()]
    aligner = SeedExtendAligner(contigs, k=args.seed_length)
    header = samio.SamHeader(sequences=[
        samio.SequenceRecord(name, len(seq), i)
        for i, (name, seq) in enumerate(contigs)])
    reader = bamio.BamReader(args.input)
    header.read_groups = reader.header.read_groups
    w = bamio.BamWriter(args.output, header)
    n = n_aligned = 0
    out = []
    for r in reader:
        n += 1
        hit = aligner.align(r.bases, min_score_frac=args.min_score_fraction)
        if hit is None:
            r.flag = (r.flag & ~0x10) | samio.UNMAPPED
            r.ref_id = -1
            r.pos = -1
            r.mapq = 0
            r.cigar_ops = np.zeros(0, np.uint8)
            r.cigar_lens = np.zeros(0, np.int32)
            out.append(r)
            continue
        n_aligned += 1
        if hit.is_reverse:
            r.bases = revcomp(r.bases)
            r.quals = r.quals[::-1].copy()
            r.flag |= 0x10
        else:
            r.flag &= ~0x10
        r.flag &= ~samio.UNMAPPED
        r.ref_id = hit.contig_index
        r.pos = hit.pos
        r.mapq = hit.mapq
        r.cigar_ops = hit.cigar_ops
        r.cigar_lens = hit.cigar_lens
        r.tags = dict(r.tags or {})
        r.tags["NM"] = hit.nm
        r.tags["AS"] = hit.score
        out.append(r)
    out.sort(key=lambda x: (x.ref_id & 0xFFFFFFFF, x.pos))
    for r in out:
        w.write(r)
    w.close()
    print(f"aligned {n_aligned}/{n} reads -> {args.output}")
    return 0


@register_tool("PathSeqBuildReferenceTaxonomy")
def pathseq_build_reference_taxonomy(argv):
    """Build the annotated taxonomy datafile for a microbe reference
    (tools/spark/pathseq/PathSeqBuildReferenceTaxonomy.java + PSBuildReferenceTaxonomyUtils):
    map each reference contig accession to a tax id via the RefSeq/GenBank
    catalog, prune the NCBI taxonomy dump to the referenced taxa plus their
    ancestors, and write the PathSeqScore taxonomy TSV (.db):
    tax_id<TAB>parent<TAB>rank<TAB>name<TAB>length<TAB>accessions."""
    p = argparse.ArgumentParser(description="PathSeqBuildReferenceTaxonomy")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--refseq-catalog", default=None,
                   help="catalog TSV(.gz): taxid, name, accession[.version], ...")
    p.add_argument("--genbank-catalog", default=None)
    p.add_argument("--tax-dump", required=True,
                   help="taxdump.tar.gz (nodes.dmp + names.dmp) or a directory")
    p.add_argument("--min-non-virus-contig-length", type=int, default=0)
    args = p.parse_args(argv)
    if not args.refseq_catalog and not args.genbank_catalog:
        from ..utils.errors import UserError
        raise UserError("at least one of --refseq-catalog or --genbank-catalog "
                        "must be specified")

    import gzip
    import os
    import tarfile

    from ..io import fasta as fasta_mod

    ref = fasta_mod.FastaReference(args.reference)
    contig_len = {name: ref.contig_length(name) for name in ref.contigs()}
    # accession = first whitespace token of the contig name, version-stripped
    acc_of = {name: name.split()[0].split("|")[-1] for name in contig_len}
    acc_base = {a.split(".")[0]: n for n, a in acc_of.items()}

    # catalog: accession -> taxid
    acc_to_tax = {}
    for cat in (args.refseq_catalog, args.genbank_catalog):
        if not cat:
            continue
        op = gzip.open if cat.endswith(".gz") else open
        with op(cat, "rt") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                try:
                    taxid = int(parts[0])
                except ValueError:
                    continue
                for tok in parts[1:]:
                    base = tok.split(".")[0]
                    if base in acc_base:
                        acc_to_tax[acc_base[base]] = taxid  # keyed by contig name

    # taxdump: nodes.dmp (taxid | parent | rank), names.dmp (scientific names)
    def _dmp_lines(member):
        if os.path.isdir(args.tax_dump):
            with open(os.path.join(args.tax_dump, member)) as fh:
                yield from fh
        else:
            with tarfile.open(args.tax_dump, "r:*") as tar:
                fh = tar.extractfile(member)
                for line in fh.read().decode().splitlines():
                    yield line

    parent, rank, names = {}, {}, {}
    for line in _dmp_lines("nodes.dmp"):
        f = [x.strip() for x in line.split("|")]
        if len(f) >= 3:
            parent[int(f[0])] = int(f[1])
            rank[int(f[0])] = f[2]
    for line in _dmp_lines("names.dmp"):
        f = [x.strip() for x in line.split("|")]
        if len(f) >= 4 and f[3] == "scientific name":
            names[int(f[0])] = f[1]

    # prune to referenced taxa + ancestors; accumulate per-taxon contig lists
    keep = {}
    for contig, taxid in acc_to_tax.items():
        length = contig_len[contig]
        # drop short non-virus contigs (virus lineages keep everything)
        lineage = []
        t = taxid
        while t in parent and t not in lineage:
            lineage.append(t)
            if parent[t] == t:
                break
            t = parent[t]
        is_virus = any(names.get(t, "") == "Viruses" for t in lineage)
        if not is_virus and length < args.min_non_virus_contig_length:
            continue
        for t in lineage:
            keep.setdefault(t, {"length": 0, "accs": []})
        keep[taxid]["length"] += length
        keep[taxid]["accs"].append(acc_of[contig])
    with open(args.output, "w") as out:
        out.write("#tax_id\tparent\trank\tname\tlength\taccessions\n")
        for t in sorted(keep):
            out.write(f"{t}\t{parent.get(t, t)}\t{rank.get(t, 'no rank')}\t"
                      f"{names.get(t, str(t))}\t{keep[t]['length']}\t"
                      f"{','.join(keep[t]['accs'])}\n")
    n_mapped = len(acc_to_tax)
    print(f"taxonomy: {len(keep)} taxa ({n_mapped}/{len(contig_len)} contigs mapped) "
          f"-> {args.output}")
    return 0


@register_tool("PathSeqPipelineSpark")
def pathseq_pipeline(argv):
    """Full PathSeq pipeline in one invocation (tools/spark/pathseq/
    PathSeqPipelineSpark.java): filter host reads -> align to the microbe
    reference -> score taxa, chaining the registered stage tools."""
    p = argparse.ArgumentParser(description="PathSeqPipelineSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--kmer-file", default=None, help="host kmer library")
    p.add_argument("--microbe-fasta", required=True)
    p.add_argument("--taxonomy-file", required=True)
    p.add_argument("--scores-output", required=True)
    p.add_argument("--output", default=None, help="aligned microbe reads BAM")
    p.add_argument("--filter-duplicates", action="store_true")
    p.add_argument("--spark-master", default=None)
    args, _unknown = p.parse_known_args(argv)

    import os
    import tempfile

    from ..cli import TOOL_REGISTRY as _REG

    d = tempfile.mkdtemp()
    filtered = os.path.join(d, "filtered.bam")
    aligned = args.output or os.path.join(d, "aligned.bam")
    sub = ["-I", args.input, "--paired-output", filtered,
           "--unpaired-output", filtered + ".unpaired.bam"]
    if args.kmer_file:
        sub += ["--kmer-file", args.kmer_file]
    rc = _REG["PathSeqFilter"](sub)
    if rc:
        return rc
    src = filtered if os.path.exists(filtered) else filtered + ".unpaired.bam"
    rc = _REG["PathSeqAlign"](["-I", src, "--microbe-fasta", args.microbe_fasta,
                               "-O", aligned])
    if rc:
        return rc
    return _REG["PathSeqScore"](["-I", aligned,
                                 "--taxonomy-file", args.taxonomy_file,
                                 "--scores-output", args.scores_output])
