"""Host seconds per pass in the reports layer: the histogram files and
CSVs written and read back (reports/csvio as exp1 bound it), the metric
arithmetic (reports/metrics as exp1 bound it), and exp6's per-k files
(pipelines/exp6._write_k_outputs)."""

SPANS = {"reports": [
    ("khoice_tpu_torch.pipelines.exp1", "write_hist_txt"),
    ("khoice_tpu_torch.pipelines.exp1", "read_hist_txt"),
    ("khoice_tpu_torch.pipelines.exp1", "write_csv_rows"),
    ("khoice_tpu_torch.pipelines.exp1", "summarize_histogram_type1"),
    ("khoice_tpu_torch.pipelines.exp1", "append_group_normalization"),
    ("khoice_tpu_torch.pipelines.exp6", "_write_k_outputs"),
]}


def read(rec):
    return rec.per_pass(rec.span_seconds("reports", SPANS))
