# Copied verbatim from gatk_tpu/utils/testdata.py; only import lines may differ.
"""Locators/parsers for reference-bundled test data (data only, no code reuse)."""
from __future__ import annotations

import os

import numpy as np

REFERENCE_ROOT = os.environ.get("GATK_REFERENCE_ROOT", f"{os.path.dirname(__file__)}/../../reference")


def reference_path(*parts):
    return os.path.join(REFERENCE_ROOT, *parts)


HMM_GOLDEN = reference_path(
    "src/test/resources/org/broadinstitute/hellbender/tools/haplotypecaller",
    "expected.Java.hmmresults.txt",
)


def load_hmm_golden_cases(path=HMM_GOLDEN):
    """Parse GATK's PairHMM golden file: hap read rq iq dq gcp expected (phred+33)."""
    cases = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            hap, rbases, rq, iq, dq, gcp, expected = line.split()
            cases.append(
                (
                    hap.encode(),
                    rbases.encode(),
                    np.frombuffer(rq.encode(), dtype=np.uint8) - 33,
                    np.frombuffer(iq.encode(), dtype=np.uint8) - 33,
                    np.frombuffer(dq.encode(), dtype=np.uint8) - 33,
                    np.frombuffer(gcp.encode(), dtype=np.uint8) - 33,
                    float(expected),
                )
            )
    return cases
