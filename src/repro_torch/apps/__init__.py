"""All-pairs applications on the port's quorum engine:

  nbody.py — direct-interaction n-body forces (paper's motivating family)
  pcit.py  — the paper's own evaluation app (gene co-expression, section 5)
"""
