"""HaplotypeCaller tool (tools/walkers/haplotypecaller/HaplotypeCaller.java CLI
equivalent). Port of gatk_tpu/tools/hc_tool.py: the same flags and output, plus
--device {cuda,cpu}, which holds for both likelihood engines (the PairHMM and
FlowBasedHMM's flow-space PairHMM). With --distributed-coordinator and
--distributed-num-processes N > 1, N processes each call their shard of the
targets on their local devices (every CUDA device, or the host with --device
cpu) and process 0 gathers the shards (parallel/multihost.py)."""
from __future__ import annotations

import torch

from ..calling import hc_engine
from ..cli import register_tool, standard_io_parser
from ..engine import intervals as iv
from ..io import fasta, vcf
from .. import devices
from ..utils import trace

VCF_HEADER_LINES = [
    '##FILTER=<ID=LowQual,Description="Low quality">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths for the ref and alt alleles in the order listed">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth (reads with MQ=255 or with bad mates are filtered)">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Normalized, Phred-scaled likelihoods for genotypes as defined in the VCF specification">',
    '##FORMAT=<ID=PGT,Number=1,Type=String,Description="Physical phasing haplotype information, describing how the alternate alleles are phased in relation to one another; will always be heterozygous and is not intended to describe called alleles">',
    '##FORMAT=<ID=PID,Number=1,Type=String,Description="Physical phasing ID information, where each unique ID within a given sample (but not across samples) connects records within a phasing group">',
    '##FORMAT=<ID=PMW,Number=1,Type=Integer,Description="Phased Min Weight, the minimum reads count to support this phased genotype">',
    '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phasing set (typically the position of the first variant in the set)">',
]


def _parser():
    """HaplotypeCaller's argument parser."""
    p = standard_io_parser("HaplotypeCaller")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the PairHMM runs: the CUDA kernel on every local GPU, "
                        "or its plain PyTorch version on the host")
    p.add_argument("--standard-min-confidence-threshold-for-calling", type=float, default=30.0)
    p.add_argument("--sample-ploidy", type=int, default=2)
    p.add_argument("--min-base-quality-score", type=int, default=10)
    p.add_argument("--dont-use-soft-clipped-bases", action="store_true")
    p.add_argument("--adaptive-pruning", action="store_true",
                   help="use the adaptive chain pruner (recommended for deep data)")
    p.add_argument("--linked-de-bruijn-graph", action="store_true",
                   help="experimental junction-tree assembly (long-range phasing)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-interval-shard checkpoint dir; reruns skip completed shards")
    p.add_argument("--shard-size", type=int, default=None,
                   help="split -L targets into shards of this many bp (the checkpoint "
                        "unit; reruns must use the same value)")
    p.add_argument("-bamout", "--bam-output", dest="bamout", default=None,
                   help="write assembled haplotypes and realigned reads to this BAM")
    p.add_argument("-G", "--annotation-group", action="append", default=[],
                   help="annotation groups (AS_StandardAnnotation enables AS_* annotations)")
    p.add_argument("--read-filter", action="append", default=[],
                   help="additional read filters by library name")
    p.add_argument("--disable-read-filter", action="append", default=[])
    p.add_argument("--filter-alleles", action="store_true",
                   help="pre-genotyping weak-allele filtering (AlleleFiltering.java)")
    p.add_argument("--prefilter-qual-threshold", type=float, default=30.0)
    p.add_argument("--prefilter-sor-threshold", type=float, default=3.0)
    p.add_argument("--max-reads-per-alignment-start", type=int, default=50)
    p.add_argument("-ERC", "--emit-ref-confidence", choices=["NONE", "GVCF"], default="NONE")
    p.add_argument("--likelihood-calculation-engine", dest="likelihood_engine",
                   choices=["PairHMM", "FlowBasedHMM"], default="PairHMM",
                   help="read likelihood engine (FlowBasedHMM: the flow-space PairHMM "
                        "for Ultima reads)")
    p.add_argument("--flow-order", default="TGCA",
                   help="flow-cycle order for FlowBasedHMM reads")
    p.add_argument("--output-mode", default="EMIT_VARIANTS_ONLY",
                   choices=["EMIT_VARIANTS_ONLY", "EMIT_ALL_CONFIDENT_SITES",
                            "EMIT_ALL_ACTIVE_SITES"])
    p.add_argument("--genotype-assignment-method", default="USE_PLS_TO_ASSIGN",
                   choices=["USE_PLS_TO_ASSIGN", "USE_POSTERIOR_PROBABILITIES"])
    p.add_argument("--flow-assembly-collapse-hmer-size", type=int, default=0,
                   help="uncollapse reference homopolymers longer than this "
                        "against the reference (flow mode; 0=off; "
                        "LongHomopolymerHaplotypeCollapsingEngine)")
    # GATK runs the AssemblyRegionTrimmer by default (HaplotypeCallerEngine.java:811);
    # --dont-trim-active-regions (AssemblyRegionTrimmerArgumentCollection) disables
    p.add_argument("--dont-trim-active-regions", dest="trimming",
                   action="store_false", default=True,
                   help="don't trim the genotyping region to the variation span "
                        "(AssemblyRegionTrimmer trim-to-variation; default trims)")
    p.add_argument("--enable-assembly-region-trimming", dest="trimming",
                   action="store_true",
                   help="(back-compat alias; trimming is on by default)")
    p.add_argument("--apply-bqd", action="store_true",
                   help="DRAGEN base-quality-dropout genotyping model")
    p.add_argument("--apply-frd", action="store_true",
                   help="DRAGEN foreign-read-detection genotyping model")
    p.add_argument("--max-effective-depth-adjustment-for-frd", type=int, default=0)
    p.add_argument("--pileup-detection", action="store_true",
                   help="create pileup-based haplotypes in addition to assembly "
                        "(DRAGEN ColumnwiseDetection; PileupBasedAlleles.java)")
    p.add_argument("--pileup-detection-enable-indel-pileup-calling",
                   dest="pileup_indels", action="store_true")
    p.add_argument("--use-pdhmm", action="store_true",
                   help="partially-determined HMM: artificial haplotypes from the "
                        "union of assembly+pileup alleles scored by the PDHMM "
                        "(PartiallyDeterminedHaplotypeComputationEngine.java)")
    p.add_argument("--pileup-detection-snp-alt-threshold", type=float, default=0.1)
    p.add_argument("--pileup-detection-indel-alt-threshold", type=float, default=0.1)
    p.add_argument("--pileup-detection-absolute-alt-depth", type=float, default=0.0)
    p.add_argument("--pileup-detection-bad-read-tolerance", type=float, default=0.0)
    p.add_argument("--dragen-378-concordance-mode", "--dragen-mode",
                   dest="dragen_mode", action="store_true",
                   help="enable the DRAGEN-GATK feature bundle incl. pileup "
                        "detection + PDHMM (getDragenVersion378NameValuePairs)")
    p.add_argument("--distributed-coordinator", default=None,
                   help="host:port of process 0 (enables multi-process mode)")
    p.add_argument("--distributed-num-processes", type=int, default=1)
    p.add_argument("--distributed-process-id", type=int, default=0)
    p.add_argument("--distributed-gather", default="collective",
                   choices=["collective", "files"],
                   help="shard gather transport: 'collective' all-gathers the shard "
                        "bytes over the torch.distributed group (no shared "
                        "filesystem needed); 'files' concatenates "
                        "<out>.shard-* on a common mount")
    p.add_argument("--distributed-shard-mode", default="contiguous",
                   choices=["contiguous", "round-robin"],
                   help="fine-shard assignment across processes: contiguous "
                        "bp-balanced runs, or round-robin interleave "
                        "(SparkSharder-style load balancing for work hotspots)")
    return p


@register_tool("HaplotypeCaller")
def haplotype_caller(argv):
    """Call germline SNPs and indels via local re-assembly of haplotypes."""
    with trace.span("hc.setup"):
        # the call's fixed cost: arguments, reference, BAM, engine, scheduler
        args = _parser().parse_args(argv)

        # the device choice holds for every PairHMM caller that passes no device
        # (the FlowBasedHMM route among them)
        devices.set_default_device(args.device)
        # None: every local CUDA device (ShardedCaller), in each process of a
        # distributed run too
        shard_devices = [torch.device("cpu")] if args.device == "cpu" else None

        distributed = args.distributed_coordinator and args.distributed_num_processes > 1
        join_init = None
        if distributed:
            from ..parallel import multihost
            # overlap the rendezvous with the opening of the reference and the
            # BAM below; joined (and its failure raised) before any collective
            join_init = multihost.start_initialize(
                args.distributed_coordinator, args.distributed_num_processes,
                args.distributed_process_id)

        ref = fasta.FastaReference(args.reference)
        from ..io.cram import open_reads
        readers = [open_reads(path, reference=ref) for path in args.input]
        if join_init is not None:
            join_init()
        header = readers[0].header
        sample = header.read_groups[0].get("SM", "SAMPLE") if header.read_groups else "SAMPLE"

        contig_lengths = {s.name: s.length for s in header.sequences}
        from ..cli_args import resolve_intervals

        targets = resolve_intervals(args, contig_lengths)
        if targets is None:
            targets = [iv.Interval(s.name, 0, s.length) for s in header.sequences]
        if args.shard_size:
            targets = [iv.Interval(t.contig, s, min(s + args.shard_size, t.end))
                       for t in targets for s in range(t.start, t.end, args.shard_size)]
        out_path = args.output
        if distributed:
            targets = multihost.shard_targets(
                targets, args.distributed_num_processes, args.distributed_process_id,
                mode=args.distributed_shard_mode)
            out_path = multihost.shard_vcf_path(args.output, args.distributed_process_id)

        hc_args = hc_engine.HCArgs(
            min_base_quality_score=args.min_base_quality_score,
            standard_confidence=args.standard_min_confidence_threshold_for_calling,
            ploidy=args.sample_ploidy,
            dont_use_soft_clipped_bases=args.dont_use_soft_clipped_bases,
            adaptive_pruning=args.adaptive_pruning,
            linked_de_bruijn_graph=args.linked_de_bruijn_graph,
            max_reads_per_alignment_start=args.max_reads_per_alignment_start,
            filter_alleles=args.filter_alleles,
            prefilter_qual_threshold=args.prefilter_qual_threshold,
            prefilter_sor_threshold=args.prefilter_sor_threshold,
            as_annotations="AS_StandardAnnotation" in args.annotation_group,
            extra_read_filters=tuple(args.read_filter),
            disabled_read_filters=tuple(args.disable_read_filter),
            likelihood_engine=args.likelihood_engine,
            flow_order=args.flow_order,
            output_mode=args.output_mode,
            genotype_assignment_method=args.genotype_assignment_method,
            assembly_region_trimming=args.trimming,
            flow_assembly_collapse_hmer_size=args.flow_assembly_collapse_hmer_size,
            apply_bqd=args.apply_bqd or args.dragen_mode,
            apply_frd=args.apply_frd or args.dragen_mode,
            max_effective_depth_adjustment_for_frd=args.max_effective_depth_adjustment_for_frd,
        )
        if args.dragen_mode or args.pileup_detection or args.use_pdhmm:
            from ..calling.pileup_alleles import PileupDetectionArgs

            pa = (PileupDetectionArgs.dragen_378() if args.dragen_mode
                  else PileupDetectionArgs(use_pileup_detection=True))
            pa.detect_indels = pa.detect_indels or args.pileup_indels
            pa.generate_pd_haplotypes = pa.generate_pd_haplotypes or args.use_pdhmm
            pa.snp_threshold = args.pileup_detection_snp_alt_threshold
            pa.indel_threshold = args.pileup_detection_indel_alt_threshold
            pa.absolute_depth = args.pileup_detection_absolute_alt_depth
            if args.pileup_detection_bad_read_tolerance > 0:
                pa.bad_read_threshold = args.pileup_detection_bad_read_tolerance
            hc_args.pileup_args = pa
        engine = hc_engine.HaplotypeCallerEngine(ref, sample, hc_args)
        if args.bamout:
            from ..calling.bamout import BamoutCollector
            contig_ids = {s.name: i for i, s in enumerate(header.sequences)}
            engine.bamout = BamoutCollector(contig_ids)
        from ..parallel.scheduler import ShardedCaller

        caller = ShardedCaller(engine, shard_devices)  # round-robins regions over the devices

        gvcf_mode = args.emit_ref_confidence == "GVCF"
        header_lines = list(VCF_HEADER_LINES)
        if gvcf_mode:
            header_lines += [
                '##ALT=<ID=NON_REF,Description="Represents any possible alternative allele">',
                '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum DP observed within the GVCF block">',
                '##INFO=<ID=END,Number=1,Type=Integer,Description="Stop position of the interval">',
            ]
        if "AS_StandardAnnotation" in args.annotation_group:
            header_lines += [
                '##INFO=<ID=AS_RAW_BaseQRankSum,Number=1,Type=String,Description="raw data for allele specific rank sum test of base qualities">',
                '##INFO=<ID=AS_RAW_MQ,Number=A,Type=Float,Description="Allele-specfic raw data for RMS Mapping Quality">',
                '##INFO=<ID=AS_RAW_MQRankSum,Number=1,Type=String,Description="Allele-specfic raw data for Mapping Quality Rank Sum">',
                '##INFO=<ID=AS_RAW_ReadPosRankSum,Number=1,Type=String,Description="allele specific raw data for rank sum test of read position bias">',
                '##INFO=<ID=AS_SB_TABLE,Number=1,Type=String,Description="Allele-specific forward/reverse read counts for strand bias tests">',
                '##FORMAT=<ID=SB,Number=4,Type=Integer,Description="Per-sample component statistics which comprise the Fisher\'s Exact Test to detect strand bias.">',
            ]
        writer = vcf.VcfWriter(
            out_path,
            [sample],
            contigs=[(s.name, s.length) for s in header.sequences],
            extra_header_lines=header_lines,
        )
        ckpt = None
        if args.checkpoint_dir:
            from ..engine.checkpoint import ShardCheckpointer
            ckpt = ShardCheckpointer(args.checkpoint_dir)
        from ..engine.progress import ProgressMeter
        from ..utils.javarandom import reset_random_generator
        pm = ProgressMeter("HaplotypeCaller", unit="variants").start()
    n = 0
    for target in targets:
        # per-target RNG reset: makes each target's output independent of which
        # process/shard computed it (exact N-process == 1-process == resume
        # equality)
        reset_random_generator()
        if ckpt is not None and ckpt.is_done(target):
            for line in ckpt.load_lines(target):
                writer.write_line(line)
                n += 1
            pm.update(f"{target.contig}:{target.end}", n=0)
            continue
        with trace.stage("bam_read", interval=target):
            reads = []
            for r in readers:
                reads.extend(r.query(target.contig, max(0, target.start - 1000), target.end + 1000))
            reads.sort(key=lambda x: (x.pos, x.name))
        if gvcf_mode:
            records = hc_engine.call_interval_gvcf(engine, reads, target, caller)
        else:
            variants, _ = caller.call_interval(reads, target)
            records = sorted(variants, key=lambda x: x.pos)
        lines = [vcf.variant_to_line(v) for v in records]
        if ckpt is not None:
            ckpt.save_lines(target, lines)
        for line in lines:
            writer.write_line(line)
            n += 1
            pm.update(f"{target.contig}:{target.end}")
    pm.stop()
    writer.close()
    if engine.bamout is not None:
        engine.bamout.write(args.bamout, header)
        print(f"wrote bamout with {len(engine.bamout.records)} records to {args.bamout}")
    if distributed:
        sort = args.distributed_shard_mode == "round-robin"
        if args.distributed_gather == "collective":
            # shared-filesystem-free: the shard bytes ride the process group
            multihost.gather_vcf_shards_collective(args.output, out_path, sort=sort)
        else:
            multihost.barrier("hc-gather")
            if args.distributed_process_id == 0:
                multihost.gather_vcf_shards(args.output, args.distributed_num_processes,
                                            sort=sort)
        multihost.shutdown()
        if args.distributed_process_id == 0:
            print(f"gathered {args.distributed_num_processes} shards into {args.output}")
    print(f"wrote {n} variants to {out_path}")
    return 0
