"""Distribution: host-side fault tolerance (the lease-based work queue)."""
