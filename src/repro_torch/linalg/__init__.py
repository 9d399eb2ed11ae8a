"""Distributed block linear algebra on the block executor: GEMM (2D
block-cyclic and 3D DNS, ``gemm.py``) and blocked Cholesky
(``cholesky.py``)."""
