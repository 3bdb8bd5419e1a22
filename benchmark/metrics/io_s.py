"""Host seconds per pass in the io layer: the database read
(pipelines/exp0.load_database_dir), the encoding of genomes and reads
(io/packing.encode_records as exp1 and exp6 bound it, exp6's
reads_matrix) and exp0's read files loaded back (cli._load_exp0)."""

SPANS = {"io": [
    ("khoice_tpu_torch.pipelines.exp0", "load_database_dir"),
    ("khoice_tpu_torch.pipelines.exp1", "encode_records"),
    ("khoice_tpu_torch.pipelines.exp6", "encode_records"),
    ("khoice_tpu_torch.pipelines.exp6", "reads_matrix"),
    ("khoice_tpu_torch.cli", "_load_exp0"),
]}


def read(rec):
    return rec.per_pass(rec.span_seconds("io", SPANS))
