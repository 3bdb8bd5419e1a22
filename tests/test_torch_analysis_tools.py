"""The port's copies of the host-only analysis and tooling
(khoice_tpu_torch/analysis/, khoice_tpu_torch/tools/download.py): the
cases of tests/test_analysis_tools.py run against them, and each output
held equal to the JAX package's copy on the same inputs (the rollup CSV
and the MSA sections byte for byte, the entropy values exactly, the
downloader's commands and files through a stubbed runner: no network).
The plots are checked to be written, as in the JAX package's tests.
"""

import math
import os

import numpy as np
import torch

from khoice_tpu.analysis import confusion_rollup as jrollup
from khoice_tpu.analysis import msa as jmsa
from khoice_tpu.tools import download as jdownload
from khoice_tpu_torch.analysis import msa
from khoice_tpu_torch.analysis.confusion_rollup import rollup_confusion_dir
from khoice_tpu_torch.tools import download

# tier-1 runs six xdist workers on the host's cores: torch's default of
# one intra-op thread per core in each would oversubscribe them
torch.set_num_threads(1)


def _stub():
    calls = []

    def runner(cmd, stdin=None):
        calls.append(cmd)
        if cmd[0] == "bash":
            return "ftp://ncbi/genomes/all/GCF_000001\nftp://ncbi/genomes/all/GCF_000002\n"
        return ""

    return calls, runner


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fd:
                out[os.path.relpath(path, root)] = fd.read()
    return out


def test_download_stubbed_equals_jax(tmp_path):
    """download_genomes through a stub runner: the commands, the
    database_{n} numbering, the url lists and the summary equal the JAX
    package's."""
    runs = {}
    for name, mod in (("port", download), ("jax", jdownload)):
        root = tmp_path / name
        root.mkdir()
        calls, runner = _stub()
        db = mod.download_genomes(["Escherichia coli", "Salmonella enterica"], str(root),
                                  num_genomes=1, runner=runner)
        db2 = mod.download_genomes(["X"], str(root), protein=True, runner=runner)
        assert os.path.basename(db) == "database_1" and os.path.basename(db2) == "database_2"
        cmds = [[str(c).replace(str(root), "ROOT") for c in cmd] for cmd in calls]
        runs[name] = (cmds, _tree(root))
    assert runs["port"] == runs["jax"]
    files = runs["port"][1]
    assert files["database_1/data/dataset_1/url_list.txt"].strip() == (
        b"ftp://ncbi/genomes/all/GCF_000001/GCF_000001_genomic.fna.gz")
    assert b"protein.faa.gz" in files["database_2/data/dataset_1/url_list.txt"]


def test_url_builders():
    d = "https://ftp.ncbi.nlm.nih.gov/genomes/all/GCF_0001.1_ASM"
    assert download.genomic_fna_url(d).endswith("GCF_0001.1_ASM_genomic.fna.gz")
    assert download.protein_faa_url(d).endswith("GCF_0001.1_ASM_protein.faa.gz")
    assert download.genomic_fna_url(d) == jdownload.genomic_fna_url(d)
    assert download.protein_faa_url(d + "/") == jdownload.protein_faa_url(d + "/")


def test_rollup_bytes_equal_jax(tmp_path):
    mdir = tmp_path / "m"
    mdir.mkdir()
    rng = np.random.default_rng(3)
    for k in ("7", "8", "21"):
        m = rng.integers(0, 50, (3, 4))
        (mdir / f"k_{k}_confusion_matrix.csv").write_text(
            "\n".join(",".join(str(x) for x in row) for row in m) + "\n")
    out = rollup_confusion_dir(str(mdir), 3, str(tmp_path / "port"), "short",
                               k_values=["7", "8", "21"])
    want = jrollup.rollup_confusion_dir(str(mdir), 3, str(tmp_path / "jax"), "short",
                                        k_values=["7", "8", "21"])
    with open(out, "rb") as a, open(want, "rb") as b:
        got = a.read()
        assert got == b.read()
    rows = got.decode().strip().split("\r\n")
    assert len(rows) == 9 and rows[0].split(",")[:2] == ["7", "0"]


def test_msa_values_equal_jax():
    """The entropy, rolling averages, cut points and sections of the port's
    msa.py equal the JAX package's on a seeded alignment with gaps."""
    assert msa.column_entropy("AAAA") == 0.0
    assert abs(msa.column_entropy("ACGT") - 2.0) < 1e-12
    rng = np.random.default_rng(9)
    rows = ["".join("ACGT-"[c] for c in rng.integers(0, 5, 400)) for _ in range(5)]
    rows[1] = rows[0][:200] + rows[1][200:]
    ent = msa.msa_entropy(rows)
    np.testing.assert_array_equal(ent, jmsa.msa_entropy(rows))
    assert msa.entropy_scores_nat(rows) == jmsa.entropy_scores_nat(rows)
    for window in (2, 50):
        np.testing.assert_array_equal(msa.rolling_average(ent, window),
                                      jmsa.rolling_average(ent, window))
        np.testing.assert_array_equal(msa.reference_rolling(list(ent), window),
                                      jmsa.reference_rolling(list(ent), window))
    smooth = msa.rolling_average(ent, 20)
    cuts = msa.find_cut_points(smooth, threshold=float(np.median(smooth)), min_gap=30)
    assert cuts == jmsa.find_cut_points(smooth, threshold=float(np.median(smooth)), min_gap=30)
    assert cuts and msa.sections_from_cuts(400, cuts) == jmsa.sections_from_cuts(400, cuts)


def _write_clustal(path, genomes, width=60):
    """Minimal clustal-style writer: 3 header lines, 60-col blocks."""
    length = len(next(iter(genomes.values())))
    with open(path, "w") as fd:
        fd.write("CLUSTAL multiple sequence alignment\n\n\n")
        for lo in range(0, length, width):
            for name, seq in genomes.items():
                fd.write(f"{name} {seq[lo:lo + width]}\n")
            fd.write("cons " + "*" * min(width, length - lo) + "\n")
            fd.write("\n")


def test_msa_sections_equal_jax(tmp_path):
    """parse_msa_file and analyze_msa_file (tests/test_analysis_tools.py::
    test_msa_reference_surface's alignment, without the figures): the
    entropy in nats and the gap-stripped section FASTAs equal the JAX
    package's, byte for byte."""
    assert abs(msa.entropy_scores_nat(["AC", "AG"])[1] - math.log(2)) < 1e-12
    n = 7000

    def seg(i):
        return (800 <= i < 3200) or (5200 <= i)

    g1 = "".join("C" if seg(i) else "A" for i in range(n))
    g2 = "".join(("-" if i % 97 == 0 else "G") if seg(i) else "A" for i in range(n))
    path = tmp_path / "virus.msa"
    _write_clustal(str(path), {"g1": g1, "g2": g2})
    entropy, genomes = msa.parse_msa_file(str(path))
    jentropy, jgenomes = jmsa.parse_msa_file(str(path))
    assert entropy == jentropy and genomes == jgenomes
    assert len(entropy) == n and genomes["g2"] == g2
    assert len(msa.reference_rolling(entropy)) == n - 249
    for name, mod in (("port", msa), ("jax", jmsa)):
        (tmp_path / name).mkdir()
        mod.analyze_msa_file(str(path), str(tmp_path / name), num_to_extract=2)
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax")
    assert set(got) >= {"seq_0_left.fna", "seq_1_left.fna", "seq_1_right.fna"}
    left1 = got["seq_1_left.fna"].decode().splitlines()[1]
    assert "-" not in left1 and len(left1) > 0


def test_plots_smoke(tmp_path):
    from khoice_tpu_torch.analysis import plots

    step5 = tmp_path / "step5.csv"
    with open(step5, "w") as fd:
        fd.write(
            "group_num,k,percent_1_occ,percent_25_or_less,percent_25_to_75,"
            "percent_75_or_more,unique_stat,unique_stat_norm,delta_frac,delta_frac_norm\n"
        )
        for g in ("group_1", "group_2"):
            for k in (7, 9, 11):
                fd.write(f"{g},{k},0.5,0.2,0.2,0.1,1.5,0.5,100.0,0.9\n")
    assert os.path.getsize(plots.plot_type1(str(step5), str(tmp_path / "t1.png"))) > 0
    acc = tmp_path / "acc.csv"
    with open(acc, "w") as fd:
        for k in (7, 9):
            for p in (0, 1):
                fd.write(f"{k},{p},10,20,3,4,10,20,3,4\n")
    assert os.path.getsize(plots.plot_accuracy_curves(str(acc), str(tmp_path / "f1.png"))) > 0
    assert os.path.getsize(plots.plot_species_comparison([str(acc)],
                                                         str(tmp_path / "sp.png"))) > 0
    cm = tmp_path / "cm.csv"
    cm.write_text("5,1\n2,6\n")
    assert os.path.getsize(plots.plot_confusion_heatmap(str(cm), str(tmp_path / "cm.png"))) > 0
    t3 = tmp_path / "t3.csv"
    with open(t3, "w") as fd:
        fd.write("read_type,pivot_num,k,dataset_num,intersection_percent\n")
        for rt in ("illumina", "ont"):
            for p in ("1", "2"):
                for k in (7, 9):
                    for ds in ("1", "2"):
                        fd.write(f"{rt},{p},{k},{ds},0.5\n")
    assert os.path.getsize(plots.plot_type3(str(t3), str(tmp_path / "t3.png"))) > 0
    out = plots.plot_database_percent({25: str(step5), 100: str(step5)}, str(tmp_path / "dp.png"))
    assert os.path.getsize(out) > 0
    csvs = {}
    for rt in ("short", "long"):
        paths = []
        for t in (1, 2):
            p = tmp_path / f"trial_{t}_{rt}_acc.csv"
            with open(p, "w") as fd:
                for k in (7, 9, 11):
                    fd.write(f"{k},0,10,20,{t},4,8,20,{t + 1},6\n")
            paths.append(str(p))
        csvs[rt] = paths
    out = plots.plot_species_read_comparison(csvs, str(tmp_path / "rd.png"))
    assert os.path.getsize(out) > 0


def test_per_script_plotters_on_the_ports_csvs(rng, tmp_path):
    """The plotters of kmer_plots_type_2/4/5.R and
    database_percent_comparison.R on the CSVs that the PORT's pipelines
    write on the CPU (tests/test_analysis_tools.py::
    test_per_script_plotters_on_pipeline_csvs with the JAX pipelines)."""
    from conftest import random_dna
    from khoice_tpu_torch.analysis import plots
    from khoice_tpu_torch.pipelines.exp2 import run_exp2
    from khoice_tpu_torch.pipelines.exp6 import run_exp6

    base = random_dna(rng, 300)
    pivots, rest = {}, {}
    for num in (1, 2):
        seqs = []
        for g in range(3):
            s = list(base)
            for _ in range(15 * num + 5 * g):
                s[rng.randrange(len(base))] = "ACGT"[rng.randrange(4)]
            seqs.append("".join(s))
        pivots[num] = [seqs[0]]
        rest[num] = [[x] for x in seqs[1:]]
    out2 = run_exp2(pivots, rest, [7, 9], str(tmp_path / "e2"), "cpu")
    names = ["Bacillus cereus", "Bacillus anthracis"]
    paths = plots.plot_type2(out2["within"], out2["across"], str(tmp_path / "p2"),
                             dataset_names=names)
    assert {"within_dataset_1_kmer_analysis.png", "within_dataset_unique_stat.png",
            "across_datasets_1_kmer_analysis.png", "across_dataset_unique_stat.png"} <= {
        os.path.basename(p) for p in paths}
    reads = {num: [pivots[num][0][i:i + 50] for i in range(0, 200, 25)] for num in rest}
    acc_csv = run_exp6(reads, rest, [7, 9], str(tmp_path / "e6"), "cpu")
    cm_txt = os.path.join(str(tmp_path / "e6"),
                          "accuracies_type_6/illumina/confusion_matrix/k_7_confusion_matrix.txt")
    p4 = plots.plot_type4(acc_csv, cm_txt, str(tmp_path / "p4"), k=7, dataset_names=names)
    assert {os.path.basename(p) for p in p4} == {"accuracy_plot.png",
                                                 "k_7_confusion_matrix_normalized.png"}
    p5 = plots.plot_type5(cm_txt, str(tmp_path / "p5"), dataset_names=names)
    assert os.path.getsize(p5) > 0
    dp = plots.plot_database_percent_bars({25: out2["across"], 100: out2["across"]},
                                          str(tmp_path / "dp"), dataset_names=names)
    assert len(dp) == 4 and all(os.path.getsize(p) > 0 for p in paths + p4 + dp)
