"""Compact chessboard for the wchess voice demo
(reference: examples/wchess/libwchess/Chessboard.{h,cpp}).

Standard piece movement with blocking/captures, full king-safety legality
(a move may not leave the mover's king in check), pawn double-step,
auto-queen promotion, castling (voiced as the king's two-square move,
e.g. "king to g1") and en passant.

The GBNF grammar for the *current* position is generated exactly like the
reference's Chessboard::setGrammar (Chessboard.cpp:545-602): alternates of
movable piece names, origin squares and reachable squares.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PIECE_NAMES = {"P": "pawn", "N": "knight", "B": "bishop", "R": "rook",
               "Q": "queen", "K": "king"}

FILES = "abcdefgh"


def sq_name(sq: int) -> str:
    return FILES[sq % 8] + str(sq // 8 + 1)


def parse_sq(s: str) -> Optional[int]:
    s = s.strip().lower()
    if len(s) == 2 and s[0] in FILES and s[1] in "12345678":
        return (int(s[1]) - 1) * 8 + FILES.index(s[0])
    return None


class Chessboard:
    def __init__(self):
        # board: dict square -> (color 'w'/'b', piece letter)
        self.board: Dict[int, Tuple[str, str]] = {}
        back = "RNBQKBNR"
        for f in range(8):
            self.board[f] = ("w", back[f])
            self.board[8 + f] = ("w", "P")
            self.board[48 + f] = ("b", "P")
            self.board[56 + f] = ("b", back[f])
        self.move_count = 0
        # castling rights (king/queen side per color) and the en-passant
        # target square left by the last double pawn step, if any
        self.castle_rights = {"wK": True, "wQ": True, "bK": True, "bQ": True}
        self.ep_square: Optional[int] = None

    @property
    def turn(self) -> str:
        return "w" if self.move_count % 2 == 0 else "b"

    # -- move generation -------------------------------------------------------

    def _pseudo_moves(self, sq: int) -> List[int]:
        color, pt = self.board[sq]
        r, f = divmod(sq, 8)
        out: List[int] = []

        def add(rr, ff) -> bool:
            """True if sliding may continue past (rr, ff)."""
            if not (0 <= rr < 8 and 0 <= ff < 8):
                return False
            t = rr * 8 + ff
            occ = self.board.get(t)
            if occ is None:
                out.append(t)
                return True
            if occ[0] != color:
                out.append(t)
            return False

        if pt == "P":
            d = 1 if color == "w" else -1
            start = 1 if color == "w" else 6
            one = (r + d) * 8 + f
            if 0 <= r + d < 8 and one not in self.board:
                out.append(one)
                two = (r + 2 * d) * 8 + f
                if r == start and two not in self.board:
                    out.append(two)
            for df in (-1, 1):
                if 0 <= f + df < 8 and 0 <= r + d < 8:
                    t = (r + d) * 8 + f + df
                    occ = self.board.get(t)
                    if (occ is not None and occ[0] != color) or t == self.ep_square:
                        out.append(t)
        elif pt == "N":
            for dr, df in ((1, 2), (2, 1), (-1, 2), (-2, 1),
                           (1, -2), (2, -1), (-1, -2), (-2, -1)):
                add(r + dr, f + df)
        elif pt == "K":
            for dr in (-1, 0, 1):
                for df in (-1, 0, 1):
                    if dr or df:
                        add(r + dr, f + df)
        else:
            dirs = []
            if pt in "RQ":
                dirs += [(1, 0), (-1, 0), (0, 1), (0, -1)]
            if pt in "BQ":
                dirs += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
            for dr, df in dirs:
                rr, ff = r + dr, f + df
                while add(rr, ff):
                    rr += dr
                    ff += df
        return out

    def _king_sq(self, color: str) -> int:
        for sq, (c, pt) in self.board.items():
            if c == color and pt == "K":
                return sq
        return -1

    def _attacked(self, sq: int, by_color: str) -> bool:
        for s, (c, pt) in list(self.board.items()):
            if c != by_color:
                continue
            if pt == "P":
                # pawns attack their diagonals whether or not occupied
                # (matters for castling-transit checks)
                d = 1 if c == "w" else -1
                r, f = divmod(s, 8)
                if 0 <= r + d < 8 and sq in (
                        (r + d) * 8 + f - 1 if f > 0 else -1,
                        (r + d) * 8 + f + 1 if f < 7 else -1):
                    return True
            elif sq in self._pseudo_moves(s):
                return True
        return False

    def _castle_moves(self, sq: int) -> List[int]:
        """King two-square castling targets (generated outside
        _pseudo_moves so _attacked never sees them as attacks)."""
        color, pt = self.board[sq]
        if pt != "K":
            return []
        home = 4 if color == "w" else 60
        if sq != home or self.in_check(color):
            return []
        enemy = "b" if color == "w" else "w"
        out = []
        for side, rook_sq, empties in (
                ("K", home + 3, (home + 1, home + 2)),
                ("Q", home - 4, (home - 1, home - 2, home - 3))):
            if not self.castle_rights[color + side]:
                continue
            if self.board.get(rook_sq) != (color, "R"):
                continue
            if any(e in self.board for e in empties):
                continue
            # the king may not pass through or land on an attacked square
            if any(self._attacked(t, enemy) for t in empties[:2]):
                continue
            out.append(empties[1])  # g-file or c-file square
        return out

    def in_check(self, color: str) -> bool:
        k = self._king_sq(color)
        return k >= 0 and self._attacked(k, "b" if color == "w" else "w")

    def legal_moves(self, sq: int) -> List[int]:
        color, pt = self.board[sq]
        out = []
        for t in self._pseudo_moves(sq):
            ep_victim = None
            if pt == "P" and t == self.ep_square:
                ep_victim = t - 8 if color == "w" else t + 8
            saved = self.board.get(t)
            saved_victim = self.board.pop(ep_victim, None) if ep_victim else None
            self.board[t] = self.board.pop(sq)
            ok = not self.in_check(color)
            self.board[sq] = self.board.pop(t)
            if saved is not None:
                self.board[t] = saved
            if saved_victim is not None:
                self.board[ep_victim] = saved_victim
            if ok:
                out.append(t)
        return out + self._castle_moves(sq)

    def all_legal(self) -> Dict[int, List[int]]:
        color = self.turn
        return {sq: mv for sq, (c, _) in list(self.board.items())
                if c == color and (mv := self.legal_moves(sq))}

    # -- voice-command interface ------------------------------------------------

    def grammar(self, prompt: str = "") -> str:
        """GBNF for the current position (Chessboard::setGrammar)."""
        legal = self.all_legal()
        if not legal:
            return ""
        piece_types = sorted({PIECE_NAMES[self.board[sq][1]] for sq in legal})
        from_pos = sorted(sq_name(sq) for sq in legal)
        to_pos = sorted({sq_name(t) for mv in legal.values() for t in mv})

        if not prompt:
            out = 'root ::= " " ((piece | frompos) " " "to "?)? topos\n'
        else:
            out = ('root ::= prompt " " frompos " " "to "? topos\n'
                   f'prompt ::= " {prompt}"\n')
        out += "piece ::= (" + " | ".join(f'"{p}"' for p in piece_types) + ")\n\n"
        out += "frompos ::= (" + " | ".join(f'"{p}"' for p in from_pos) + ")\n"
        out += "topos ::= (" + " | ".join(f'"{p}"' for p in to_pos) + ")\n"
        return out

    def process(self, command: str) -> str:
        """Parse a voice command and apply the move
        (Chessboard::process/parseCommand).  Returns 'e2-e4' or ''. """
        words = [w.strip(" ,.!?").lower() for w in command.split()]
        words = [w for w in words if w and w != "to"]
        if not words:
            return ""
        legal = self.all_legal()

        src: Optional[int] = None
        dst: Optional[int] = None
        name_to_pt = {v: k for k, v in PIECE_NAMES.items()}
        if words[0] in name_to_pt:
            pt = name_to_pt[words[0]]
            dst = parse_sq(words[-1])
            cands = [sq for sq in legal
                     if self.board[sq][1] == pt and dst in legal[sq]]
            if len(cands) != 1:
                return ""
            src = cands[0]
        else:
            src = parse_sq(words[0])
            dst = parse_sq(words[-1]) if len(words) > 1 else None
            if src is None and dst is None:
                return ""
            if src is not None and dst is None and src not in legal:
                # a single square names the destination
                dst, src = src, None
            if src is None:
                cands = [sq for sq in legal if dst in legal[sq]]
                if len(cands) != 1:
                    return ""
                src = cands[0]
        if src not in legal or dst not in legal[src]:
            return ""

        color, pt = self.board.pop(src)
        next_ep: Optional[int] = None
        if pt == "P":
            if dst == self.ep_square:  # en-passant capture
                self.board.pop(dst - 8 if color == "w" else dst + 8, None)
            if abs(dst - src) == 16:   # double step leaves an ep target
                next_ep = (src + dst) // 2
            if dst // 8 in (0, 7):
                pt = "Q"  # auto-queen
        elif pt == "K":
            if abs(dst - src) == 2:    # castling: move the rook too
                if dst > src:
                    self.board[src + 1] = self.board.pop(src + 3)
                else:
                    self.board[src - 1] = self.board.pop(src - 4)
            self.castle_rights[color + "K"] = False
            self.castle_rights[color + "Q"] = False
        for corner, key in ((0, "wQ"), (7, "wK"), (56, "bQ"), (63, "bK")):
            # a rook moving or being captured forfeits that side's right
            if src == corner or dst == corner:
                self.castle_rights[key] = False
        self.board[dst] = (color, pt)
        self.ep_square = next_ep
        self.move_count += 1
        return f"{sq_name(src)}-{sq_name(dst)}"

    def stringify(self) -> str:
        """ASCII board (Chessboard::stringifyBoard)."""
        lines = [" ".join(FILES)]
        for r in range(7, -1, -1):
            row = []
            for f in range(8):
                p = self.board.get(r * 8 + f)
                if p:
                    ch = p[1].lower() if p[0] == "b" else p[1]
                    row.append(ch)
                else:
                    row.append("." if (r + f) % 2 else "*")
            lines.append(" ".join(row) + f" {r + 1}")
        return "\n".join(lines) + "\n"
