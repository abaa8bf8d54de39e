"""General traffic drivers, named by a mix's ``driver`` key."""
