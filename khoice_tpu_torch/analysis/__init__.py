"""Host-only analysis of the experiments' outputs (copies of khoice_tpu/analysis/):
the confusion rollup, MSA entropy sections and the plots.  `plots.py` and
`msa.py`'s figures import matplotlib when called; nothing the CLI runs
imports them."""
