"""Code construction: ALIST parsing, GF(2) algebra, QC layout, standards."""
