"""Core support-core machinery of the port: packets, free-list metadata,
HMQ scheduling, the plain scheduled step, lane stash and paged KV."""
