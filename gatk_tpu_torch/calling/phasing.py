# Copied verbatim from gatk_tpu/calling/phasing.py; only import lines may differ.
"""Physical phasing of calls sharing haplotype support (PGT/PID/PS/PMW).

Reference behavior: haplotypecaller/AssemblyBasedCallerUtils.java phaseCalls
:730-741, constructHaplotypeMapping :752-772, constructPhaseSetMapping :807-916
(including this fork's weakness-based top-2 phase-group selection and
phase-diffusion relaxation), constructPhaseGroups :919-950, phaseVC :986-1008.

Calls in one assembled region whose alt alleles ride the same (cis -> same PGT)
or complementary (trans -> opposite PGT) haplotype sets get a phase group:
FORMAT fields PGT ("0|1"/"1|0"), PID (pos_ref_alt of the leftmost member),
PS (leftmost member's 1-based position), PMW (min phase read weight), and a
phased GT for hets.
"""
from __future__ import annotations

MIN_ALT_ALLELE_DEPTH_FOR_PHASE = 3  # AssemblyBasedCallerUtils.java:60
MAX_CALL_DISTANCE_FOR_PHASE = 13  # :61
PHASE_01, PHASE_10 = "0|1", "1|0"


def _pair_depth(variant):
    """(first-alt depth, total depth) from the AD field (getPairDepth :787)."""
    ad = variant.samples[0].get("AD")
    if not ad:
        return 0, 0
    parts = [int(x) for x in ad.split(",")]
    first_alt = parts[1] if len(parts) > 1 else 0
    return first_alt, sum(parts)


def _site_specific_alt(variant):
    """First alt allele that is a real sequence allele (not <NON_REF>/*)."""
    for a in variant.alts:
        if a != "*" and not a.startswith("<"):
            return a
    return None


def phase_calls(calls, call_support, hap_weakness):
    """Annotate phased calls in place; returns calls.

    calls: Variant list in position order for one assembled region.
    call_support: {id(variant): frozenset of haplotype ids supporting its first
        site-specific alt allele} (constructHaplotypeMapping).
    hap_weakness: {haplotype id: weakness (min supporting reads)}.
    """
    n = len(calls)
    if n < 2:
        return calls
    total_haps = len({h for s in call_support.values() for h in s})
    if total_haps == 0:
        return calls

    # phaseSetMapping: id(call) -> (group, phase_read_count, phase_gt)
    mapping = {}
    unique_counter = 0

    def first_group_gt():
        for v in mapping.values():
            return v[2]
        return PHASE_10

    def maybe_open_group(call, comp, phase_reads):
        """Fork behavior: keep only the top-2 phase groups by weakness."""
        nonlocal unique_counter
        min_weak = min((v[1] for v in mapping.values()), default=0)
        if unique_counter < 2 or phase_reads > min_weak:
            if unique_counter > 1:
                for k in [k for k, v in mapping.items() if v[1] <= min_weak]:
                    del mapping[k]
            gt = PHASE_01 if first_group_gt() == PHASE_10 else PHASE_10
            mapping[id(call)] = (unique_counter, phase_reads, gt)
            if comp is not None:
                mapping[id(comp)] = (unique_counter, phase_reads, gt)
            unique_counter += 1
            return True
        return False

    for i in range(n - 1):
        call = calls[i]
        call_depth, call_total = _pair_depth(call)
        haps_call = call_support.get(id(call), frozenset())
        if not haps_call or call_depth < MIN_ALT_ALLELE_DEPTH_FOR_PHASE:
            continue
        call_on_all = len(haps_call) == total_haps
        call_haps_available = set(haps_call)
        for j in range(i + 1, n):
            comp = calls[j]
            comp_depth, comp_total = _pair_depth(comp)
            haps_comp = call_support.get(id(comp), frozenset())
            if (comp.pos > call.pos + len(call.ref) - 1 + MAX_CALL_DISTANCE_FOR_PHASE
                    or not haps_comp or comp_depth < MIN_ALT_ALLELE_DEPTH_FOR_PHASE):
                continue
            comp_on_all = len(haps_comp) == total_haps
            intersection = haps_call & haps_comp
            phase_reads = max((hap_weakness.get(h, 0) for h in intersection), default=0)
            import math

            diffusion = 2 * math.log10(max(min(call_depth, comp_depth), 1)) + 1
            min_total = min(call_total, comp_total)
            min_phase_reads = (-(-min_total // 700) if min_total > 2798
                               else MIN_ALT_ALLELE_DEPTH_FOR_PHASE)
            same_set = (len(haps_call) == len(haps_comp)
                        and (haps_call <= haps_comp or haps_comp <= haps_call))
            if (same_set
                    or (phase_reads >= min_phase_reads
                        and (phase_reads * diffusion > call_depth
                             or phase_reads * diffusion > comp_depth))
                    or (call_on_all and call_haps_available >= haps_comp)
                    or comp_on_all):
                if id(call) not in mapping:
                    if maybe_open_group(call, comp, phase_reads):
                        call_haps_available &= haps_comp
                elif id(comp) not in mapping:
                    g = mapping[id(call)]
                    mapping[id(comp)] = (g[0], phase_reads, g[2])
            elif len(haps_call) + len(haps_comp) == total_haps:
                if not intersection and id(call) not in mapping:
                    maybe_open_group(call, None, phase_reads)

    # constructPhaseGroups: annotate by group in original order
    groups = {}
    for idx, call in enumerate(calls):
        if id(call) in mapping:
            groups.setdefault(mapping[id(call)][0], []).append(idx)
    for members in groups.values():
        if not members:
            continue
        lead = calls[members[0]]
        pid = f"{lead.pos + 1}_{lead.ref}_{lead.alts[0]}"
        ps = lead.pos + 1
        for idx in members:
            v = calls[idx]
            _, phase_reads, pgt = mapping[id(v)]
            _apply_phase(v, pid, pgt, phase_reads, ps)
    return calls


def _apply_phase(variant, pid, pgt, pmw, ps):
    g = variant.samples[0]
    gt = g.get("GT", "")
    sep = "|" if "|" in gt else "/"
    alleles = gt.split(sep) if gt else []
    if len(alleles) == 2:
        if alleles[0] != alleles[1]:
            # het: order per the phase group (phaseVC; site-specific alt on the
            # PGT's alt side)
            a, b = sorted(alleles)
            g["GT"] = f"{a}|{b}" if pgt == PHASE_01 else f"{b}|{a}"
        else:
            g["GT"] = f"{alleles[0]}|{alleles[1]}"
    g["PGT"] = pgt
    g["PID"] = pid
    g["PS"] = str(ps)
    g["PMW"] = str(pmw)
    if "PGT" not in variant.fmt_keys:
        variant.fmt_keys = tuple(variant.fmt_keys) + ("PGT", "PID", "PS", "PMW")
