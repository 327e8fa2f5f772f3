"""Container package for the port's copy of the compiled native env pool.

Wheel builds place ``libdfd_envpool.so`` here (see setup.py); in a source
checkout the port builds its own from ``runtime/envpool.cc`` instead.  The
ctypes loader (``dfd_tpu_torch.envs.native_pool``) searches
``DFD_ENVPOOL_LIB``, then the checkout's build, then here.
"""
