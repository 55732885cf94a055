"""Cost accounting of the port: what a step computes, moves and holds."""
