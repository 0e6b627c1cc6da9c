"""System keyspace conventions (trimmed copy of
foundationdb_tpu/server/system_data.py, reference fdbclient/SystemData.cpp).

Only what the resolution plane reads: the first key of the `\\xff` system
range, which every resolver owns (RESOLVER_ALL) and whose mutations make
a transaction a state transaction.
"""

SYSTEM_KEYS_BEGIN = b"\xff"
