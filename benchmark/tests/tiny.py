"""Tiny sizes of the cells' configurations and mixes, for the CPU."""

CONFIG = {
    "scer-wgs-k21": {"genome_bases": 6000, "n_reads": 500,
                     "substitution_rate": 0.01},
    "grch38-chr1-k31": {"total_bases": 40000,
                        "n_runs": {"telomere_bases": 100,
                                   "centromere_bases": 3000,
                                   "small_gaps": 6, "small_gap_bases": 40}},
}
# the fold at a tiny size (count_file would take its single-shot route)
MIX = {"scer-wgs-k21.fastq": {"options": {"single_shot": False,
                                          "batch": 128}},
       "scer-wgs-k21.packed": {"batch": 128},
       "grch38-chr1-k31.fasta": {"options": {"single_shot": False,
                                             "batch": 16}}}


def config(workload: str) -> dict:
    return CONFIG[workload.split(".")[0]]
