"""foundationdb_tpu_torch: the Resolver role and its conflict check in
PyTorch + CUDA.

A port of the resolver of `foundationdb_tpu` (JAX), the role and the
device layer under it, to PyTorch on an NVIDIA Hopper GPU.  The layout
mirrors the JAX package module for module, so each counterpart sits at
the same relative path:

  txn/       -- Version, KeyRange, Mutation, CommitTransactionRef,
                CommitResult
  core/      -- FdbError / err(), server and client knobs, BUGGIFY, trace
                events, histograms, futures and actors, the virtual-time
                EventLoop and the hook for a caller's loop
  rpc/       -- request streams delivered within the process
  client/    -- Database and Transaction (read-your-writes, the retry
                loop, GRV batching, replica failover)
  testing/   -- the Cycle and ReadWrite workloads
  ops/       -- digest encode (host) + search, rank, scan and range-max
                (device: plain-torch versions beside CUDA kernel wrappers)
  conflict/  -- EncodedBatch, the ConflictSet contract, the CPU oracle, the
                fused per-batch steps + merge (fused.py), the window
                programs (window.py), the backend that drives them
                (torch_backend.py) and the supervision layer over it
                (supervisor.py)
  parallel/  -- the same sharded by key range over a grid of devices
                (ConflictMesh, ShardedTorchConflictSet, ShardedWindow)
  server/    -- the Resolver role over those sets: resolveBatch with its
                version chain, resend cache, state-transaction broadcast
                and heat tracker (conflict/heat.py)
  kernels/   -- nvcc build of csrc/*.cu, ctypes bindings, launch counters
  csrc/      -- the hand-written CUDA kernels (sm_90a)
  entry.py   -- the entry points, as __graft_entry__.py's: window_query
                at the reference's shapes, and a sharded dry run across a
                mesh

The package imports torch and numpy only.  Entry points run on `cuda`
unless the caller passes `device="cpu"`; with no device given and no CUDA
present, construction raises instead of quietly running on the CPU.
"""
