# Copied verbatim from gatk_tpu/tools/spark_compat.py; only import lines may differ.
"""Spark-named tool compatibility layer.

Reference behavior: the `*Spark` tools under tools/spark/ run the SAME
algorithms as their single-node namesakes on a Spark cluster
(engine/spark/GATKSparkTool.java). This framework's distribution layer is
jax.distributed SPMD instead (parallel/multihost.py) — there is no separate
cluster binary — so each Spark-named tool maps onto the equivalent
TPU-native implementation, with Spark-runner flags (--spark-master,
--spark-runner, --num-executors, --executor-memory, --conf, --sharded-output)
accepted and ignored. This keeps published GATK command lines
(e.g. `gatk MarkDuplicatesSpark -I in.bam -O out.bam`) working verbatim.

MarkDuplicatesSpark output matches single-node MarkDuplicates by design in
the reference too (MarkDuplicatesSpark.java:77 "exactly matches the ordinary
MarkDuplicates").
"""
from __future__ import annotations

from ..cli import TOOL_REGISTRY, register_tool

SPARK_ONLY_FLAGS_WITH_VALUE = {
    "--spark-master", "--spark-runner", "--num-executors", "--executor-memory",
    "--executor-cores", "--driver-memory", "--conf", "--num-reducers",
    "--bam-partition-size", "--cluster", "--project",
}
SPARK_ONLY_FLAGS_BARE = {"--sharded-output", "--use-nio", "--splitting-index-granularity"}


def _strip_spark_args(argv):
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in SPARK_ONLY_FLAGS_WITH_VALUE:
            i += 2
            continue
        if a in SPARK_ONLY_FLAGS_BARE or a.startswith("--spark-"):
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def _alias(spark_name: str, target: str):
    def run(argv, _target=target, _name=spark_name):
        fn = TOOL_REGISTRY[_target]
        return fn(_strip_spark_args(argv))

    run.__doc__ = (f"{spark_name}: Spark-cluster surface of {target} "
                   f"(tools/spark/); routed to the TPU-native {target} "
                   f"implementation, Spark runner flags ignored.")
    register_tool(spark_name, alias_of=target)(run)


_ALIASES = [
    ("MarkDuplicatesSpark", "MarkDuplicates"),
    ("SortSamSpark", "SortSam"),
    ("PrintReadsSpark", "PrintReads"),
    ("FlagStatSpark", "FlagStat"),
    ("CountReadsSpark", "CountReads"),
    ("CountBasesSpark", "CountBases"),
    ("CountVariantsSpark", "CountVariants"),
    ("PrintVariantsSpark", "PrintVariants"),
    ("ExampleReadWalkerWithReferenceSpark", "ExampleReadWalkerWithReference"),
    ("ExampleReadWalkerWithVariantsSpark", "ExampleReadWalkerWithVariants"),
    ("ExampleLocusWalkerSpark", "ExampleLocusWalker"),
    ("ExampleIntervalWalkerSpark", "ExampleIntervalWalker"),
    ("ExampleVariantWalkerSpark", "ExampleVariantWalker"),
    ("ExampleAssemblyRegionWalkerSpark", "ExampleAssemblyRegionWalker"),
    ("ExampleCollectSingleMetricsSpark", "CollectInsertSizeMetrics"),
    ("ExampleCollectMultiMetricsSpark", "CollectMultipleMetrics"),
    ("PileupSpark", "Pileup"),
    ("BaseRecalibratorSpark", "BaseRecalibrator"),
    ("ApplyBQSRSpark", "ApplyBQSR"),
    ("BQSRPipelineSpark", "ReadsPipeline"),
    ("ReadsPipelineSpark", "ReadsPipeline"),
    ("HaplotypeCallerSpark", "HaplotypeCaller"),
    ("CollectAllelicCountsSpark", "CollectAllelicCounts"),
    ("CollectInsertSizeMetricsSpark", "CollectInsertSizeMetrics"),
    ("CollectQualityYieldMetricsSpark", "CollectQualityYieldMetrics"),
    ("MeanQualityByCycleSpark", "MeanQualityByCycle"),
    ("QualityScoreDistributionSpark", "QualityScoreDistribution"),
    ("RevertSamSpark", "RevertSam"),
    ("PathSeqFilterSpark", "PathSeqFilter"),
    ("PathSeqScoreSpark", "PathSeqScore"),
    ("PathSeqBwaSpark", "PathSeqAlign"),
    ("GatherVcfsCloud", "GatherVcfs"),
    ("CollectBaseDistributionByCycleSpark", "CollectBaseDistributionByCycle"),
    ("CollectMultipleMetricsSpark", "CollectMultipleMetrics"),
    # the modern in-repo SV discoverer supersedes both Spark-era entry points
    # for calling SVs from assembled-contig alignments
    ("SvDiscoverFromLocalAssemblyContigAlignmentsSpark", "StructuralVariantDiscoverer"),
    ("DiscoverVariantsFromContigAlignmentsSAMSpark", "StructuralVariantDiscoverer"),
]
assert len({s for s, _ in _ALIASES}) == len(_ALIASES), "duplicate Spark alias names"
for _spark, _single in _ALIASES:
    if _single in TOOL_REGISTRY:
        _alias(_spark, _single)
