"""Operations and bytes of the measured work, from a configuration's shapes,
and the card's published peaks."""
