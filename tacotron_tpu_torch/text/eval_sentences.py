"""Default Korean evaluation sentences.

The reference hardcodes a similar list in ``eval.py:13-66`` and validates it
at trainer startup (``train.py:27-40``).  These are original phrases with the
same coverage intent: numbers, dates, quotes, and long clauses.
"""

EVAL_TEXTS = [
    "안녕하세요 오늘도 좋은 하루 되시기 바랍니다",
    "기상청은 내일 아침 기온이 영하 삼 도까지 떨어진다고 예보했습니다",
    "서울역에서 부산역까지는 약 두 시간 삼십 분이 걸립니다",
    "그는 웃으며 정말 반가웠다고 말했습니다",
    "올해 경제 성장률은 이 점 오 퍼센트로 전망됩니다",
    "다음 회의는 시월 십오 일 오후 세 시에 열립니다",
    "인공지능 기술은 음성 합성 분야에서 빠르게 발전하고 있습니다",
    "창밖으로 보이는 가을 하늘이 유난히 맑고 푸르렀습니다",
]
