"""The hand-written CUDA kernels and their wrappers.

The card the launch plans assume where they are not told the card's
own figures, one place for the whole port:"""

#: the streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: the most shared memory one block may ask for on an H100 (227 KB)
H100_MAX_SMEM = 232448
