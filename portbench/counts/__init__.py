"""Operations and bytes of the work, from shapes alone: the same count
whatever implements the work."""
