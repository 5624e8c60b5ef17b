"""Device-resident stateful kernels: the hash table and grouped agg.

    hash_table   open-addressing table; ``probe_insert`` is kernel K1
    hash_agg     grouped aggregation state; kernels K2 (apply), K3 (flush
                 gather + advance) and K4 (rebuild: live mask + remap)
    lanes        host codecs for 64-bit values as int32 lanes
    cuda         nvcc build and ctypes binding of ``csrc/``
"""
