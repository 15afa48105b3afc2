"""Distribution: host-side fault tolerance (work queue, heartbeat, restartable loop)."""
