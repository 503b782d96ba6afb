# Copied verbatim from gatk_tpu/tools/ramped_hc_tool.py; only import lines and the RampedHaplotypeCaller --device flag (ramped_hc_tool.py:86) differ.
"""RampedHaplotypeCaller: HC broken into checkpointable steps via state zips.

Reference behavior: tools/walkers/haplotypecaller/RampedHaplotypeCaller.java +
RampedHaplotypeCallerEngine.java + ramps/ — run the HC pipeline up to a step
(an "off ramp"), serialize the intermediate state to a zip, and later restart
from that state (an "on ramp"):

  off-ramp-type PRE_ASSEMBLER_OFF  — stop after region finalization (reads per
                                     active region saved)
  off-ramp-type POST_ASSEMBLER_OFF — stop after assembly (haplotypes saved too)
  on-ramp-type  POST_ASSEMBLER_ON  — resume from saved assembly state, run
                                     PairHMM + genotyping to a VCF

State format (re-designed SoA, not the reference's Java serialization): a zip
with a JSON manifest + one .npz per region holding the finalized reads as
structure-of-arrays and the assembled haplotype bases/scores.
"""
from __future__ import annotations

import argparse
import io as _io
import json
import zipfile

import numpy as np

from ..calling import hc_engine
from ..cli import register_tool
from ..engine import intervals as iv
from ..io import fasta, vcf
from ..io.reads import Read
from .hc_tool import VCF_HEADER_LINES
from .. import devices

OFF_RAMP_TYPES = ("NONE", "PRE_ASSEMBLER_OFF", "POST_ASSEMBLER_OFF")
ON_RAMP_TYPES = ("NONE", "POST_ASSEMBLER_ON")


def _reads_to_npz(reads):
    out = {}
    out["name"] = np.array([r.name for r in reads])
    for k in ("flag", "pos", "mapq", "tlen"):
        out[k] = np.array([getattr(r, k) for r in reads], np.int64)
    out["bases"] = np.concatenate([r.bases for r in reads]) if reads else np.zeros(0, np.uint8)
    out["quals"] = np.concatenate([r.quals for r in reads]) if reads else np.zeros(0, np.uint8)
    out["blen"] = np.array([len(r.bases) for r in reads], np.int64)
    out["cops"] = np.concatenate([r.cigar_ops for r in reads]) if reads else np.zeros(0, np.uint8)
    out["clens"] = np.concatenate([r.cigar_lens for r in reads]) if reads else np.zeros(0, np.int32)
    out["cn"] = np.array([len(r.cigar_ops) for r in reads], np.int64)
    return out


def _reads_from_npz(z, ref_id=0):
    reads = []
    b0 = q0 = c0 = 0
    for i in range(len(z["name"])):
        bl, cn = int(z["blen"][i]), int(z["cn"][i])
        reads.append(Read(
            name=str(z["name"][i]), flag=int(z["flag"][i]), ref_id=ref_id,
            pos=int(z["pos"][i]), mapq=int(z["mapq"][i]),
            cigar_ops=z["cops"][c0 : c0 + cn].astype(np.uint8),
            cigar_lens=z["clens"][c0 : c0 + cn].astype(np.int32),
            bases=z["bases"][b0 : b0 + bl], quals=z["quals"][q0 : q0 + bl],
            tlen=int(z["tlen"][i])))
        b0 += bl
        q0 += bl
        c0 += cn
    return reads


@register_tool("RampedHaplotypeCaller")
def ramped_haplotype_caller(argv):
    """HC with off/on-ramp state serialization
    (haplotypecaller/RampedHaplotypeCaller.java)."""
    p = argparse.ArgumentParser(description="RampedHaplotypeCaller")
    p.add_argument("-I", "--input", action="append")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--off-ramp-type", choices=OFF_RAMP_TYPES, default="NONE")
    p.add_argument("--off-ramp-file", default=None)
    p.add_argument("--on-ramp-type", choices=ON_RAMP_TYPES, default="NONE")
    p.add_argument("--on-ramp-file", default=None)
    p.add_argument("--max-reads-per-alignment-start", type=int, default=50)
    p.add_argument("--adaptive-pruning", action="store_true")
    p.add_argument("--sample-ploidy", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the PairHMM runs: the CUDA kernel, or its plain "
                        "PyTorch version on the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    ref = fasta.FastaReference(args.reference)
    hc_args = hc_engine.HCArgs(
        ploidy=args.sample_ploidy, adaptive_pruning=args.adaptive_pruning,
        max_reads_per_alignment_start=args.max_reads_per_alignment_start)

    if args.on_ramp_type == "POST_ASSEMBLER_ON":
        # resume from saved assembly state
        from ..assembly.haplotype import Haplotype, build_event_map

        zf = zipfile.ZipFile(args.on_ramp_file)
        manifest = json.loads(zf.read("manifest.json"))
        sample = manifest["sample"]
        engine = hc_engine.HaplotypeCallerEngine(ref, sample, hc_args)
        writer = vcf.VcfWriter(args.output, [sample],
                               contigs=[(c, ref.contig_length(c))
                                        for c in ref.contigs()],
                               extra_header_lines=list(VCF_HEADER_LINES))
        n = 0
        from ..ops.pairhmm import PoolBatcher
        batcher = PoolBatcher()
        preps = []
        for entry in manifest["regions"]:
            z = np.load(_io.BytesIO(zf.read(entry["npz"])), allow_pickle=False)
            reads = _reads_from_npz(z)
            span = iv.Interval(entry["contig"], entry["start"], entry["end"])
            padded = iv.Interval(entry["contig"], entry["pstart"], entry["pend"])
            ref_bases = ref.fetch(entry["contig"], entry["pstart"], entry["pend"])
            # re-derive each haplotype's cigar vs the padded reference (the
            # off-ramp stores bases only; the SW alignment is recomputed like
            # ReadThreadingAssembler.findBestPaths :324 does at assembly time)
            from ..ops import smith_waterman as sw

            hb, hs = z["hap_bases"], z["hap_blen"]
            bases_list = []
            off = 0
            for j in range(len(hs)):
                bases_list.append(bytes(hb[off : off + int(hs[j])]))
                off += int(hs[j])
            alns = sw.align_batch(bytes(ref_bases), bases_list,
                                  sw.NEW_SW_PARAMETERS, sw.SOFTCLIP)
            haps = []
            for j, (b, aln) in enumerate(zip(bases_list, alns)):
                h = Haplotype(b, is_ref=bool(z["hap_is_ref"][j]),
                              score=float(z["hap_score"][j]),
                              cigar_ops=aln.cigar_ops, cigar_lens=aln.cigar_lens,
                              alignment_start=entry["pstart"] + aln.offset)
                build_event_map(h, ref_bases, entry["pstart"])
                haps.append(h)
            from ..calling import read_prep
            prepped = read_prep.prepare_reads_for_pairhmm(reads)
            handle = batcher.add_region(prepped, [h.bases for h in haps])
            preps.append(dict(span=span, padded=padded, final_reads=reads,
                              prepped=prepped, haplotypes=haps,
                              ref_bases=ref_bases, handle=handle))
        batcher.flush()
        variants = []
        for prep in preps:
            v, _ = engine.finish_region(prep)
            variants.extend(v)
        for v in sorted(variants, key=lambda x: (x.contig, x.pos)):
            writer.write(v)
            n += 1
        writer.close()
        print(f"RampedHaplotypeCaller (on-ramp): wrote {n} variants to {args.output}")
        return 0

    # forward path: plan + finalize (+ assemble) and off-ramp
    from ..io.cram import open_reads

    readers = [open_reads(path, reference=ref) for path in args.input or []]
    header = readers[0].header
    sample = header.read_groups[0].get("SM", "SAMPLE") if header.read_groups else "SAMPLE"
    contig_lengths = {s.name: s.length for s in header.sequences}
    targets = (iv.parse_intervals_arg(args.intervals, contig_lengths)
               if args.intervals else
               [iv.Interval(s.name, 0, s.length) for s in header.sequences])
    engine = hc_engine.HaplotypeCallerEngine(ref, sample, hc_args)

    if args.off_ramp_type == "NONE":
        # plain HC run (debugging parity: RampedHaplotypeCaller with no ramps
        # behaves as HaplotypeCaller)
        from .hc_tool import VCF_HEADER_LINES as _hl
        writer = vcf.VcfWriter(args.output, [sample],
                               contigs=[(s.name, s.length) for s in header.sequences],
                               extra_header_lines=list(_hl))
        n = 0
        for t in targets:
            reads = []
            for r in readers:
                reads.extend(r.query(t.contig, max(0, t.start - 1000), t.end + 1000))
            reads.sort(key=lambda x: (x.pos, x.name))
            variants, _ = engine.call_interval(reads, t)
            for v in sorted(variants, key=lambda x: x.pos):
                writer.write(v)
                n += 1
        writer.close()
        print(f"RampedHaplotypeCaller: wrote {n} variants to {args.output}")
        return 0

    regions = []
    for t in targets:
        reads = []
        for r in readers:
            reads.extend(r.query(t.contig, max(0, t.start - 1000), t.end + 1000))
        reads.sort(key=lambda x: (x.pos, x.name))
        usable, spans = engine.plan_interval(reads, t)
        for span in spans:
            contig_len = ref.contig_length(span.contig)
            padded = span.expand(hc_engine.REGION_PADDING, contig_len)
            region_reads = [r for r in usable
                            if r.pos < padded.end and r.end > padded.start]
            final = hc_engine.finalize_region_reads(region_reads, padded, hc_args)
            if not final:
                continue
            entry = dict(contig=span.contig, start=span.start, end=span.end,
                         pstart=padded.start, pend=padded.end)
            data = _reads_to_npz(final)
            if args.off_ramp_type == "POST_ASSEMBLER_OFF":
                from ..assembly import assembler
                ref_bases = ref.fetch(span.contig, padded.start, padded.end)
                result = assembler.assemble(
                    final, ref_bases, padded.start,
                    min_base_qual=hc_args.min_base_quality_score,
                    adaptive_pruning=hc_args.adaptive_pruning)
                haps = result.haplotypes
                data["hap_bases"] = (np.concatenate(
                    [np.frombuffer(bytes(h.bases), np.uint8) for h in haps])
                    if haps else np.zeros(0, np.uint8))
                data["hap_blen"] = np.array([len(h.bases) for h in haps], np.int64)
                data["hap_is_ref"] = np.array([h.is_ref for h in haps], bool)
                data["hap_score"] = np.array(
                    [h.score if h.score is not None else 0.0 for h in haps])
            regions.append((entry, data))

    out_zip = args.off_ramp_file or args.output
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        manifest = dict(sample=sample, step=args.off_ramp_type, regions=[])
        for i, (entry, data) in enumerate(regions):
            npz_name = f"region_{i:05d}.npz"
            buf = _io.BytesIO()
            np.savez(buf, **data)
            zf.writestr(npz_name, buf.getvalue())
            entry["npz"] = npz_name
            manifest["regions"].append(entry)
        zf.writestr("manifest.json", json.dumps(manifest))
    print(f"RampedHaplotypeCaller: off-ramp {args.off_ramp_type} saved "
          f"{len(regions)} regions to {out_zip}")
    return 0
