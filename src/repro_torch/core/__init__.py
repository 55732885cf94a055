"""ACE-Sync core of the port: compression, plans, sync, trainer."""
