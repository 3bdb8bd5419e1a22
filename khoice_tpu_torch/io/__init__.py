# Copied from khoice_tpu/io/__init__.py.
from .fasta import read_fasta, write_fasta, fasta_lengths, FastaRecord
from .packing import encode_seq, encode_records, SEP_CODE

__all__ = [
    "read_fasta",
    "write_fasta",
    "fasta_lengths",
    "FastaRecord",
    "encode_seq",
    "encode_records",
    "SEP_CODE",
]
