"""Walk modes, the walk engine and the SGNS embedding trainer."""
