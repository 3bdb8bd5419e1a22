"""Host tooling (a copy of khoice_tpu/tools/): the NCBI downloader."""
