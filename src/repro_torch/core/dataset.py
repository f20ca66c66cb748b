"""MCP server dataset + MCPBench-style query dataset construction
(paper Sec. III-A Module 1 and Sec. V-A).

The port's own copy of `repro.core.dataset`: numpy's ``default_rng``
draws the same numbers from the same seed, so pools and query sets are
equal to the reference's.

The experimental pool mirrors the paper: 15 servers — 5 websearch-capable
servers sharing one backend but with LLM-diversified descriptions (we
diversify with a seeded synonym paraphraser, standing in for the paper's
Qwen3-32B polishing), plus 10 distractor servers from unrelated domains
(code modification, Amazon product search, databases, ...).

`mock_cluster` provides the paper's "flexible simulation of large-scale
server clusters": replicate template servers into N virtual instances with
independent network profiles (used by the fleet-scale benchmarks and the
serving gateway).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

WEBSEARCH = "websearch"


@dataclasses.dataclass
class Tool:
    name: str
    description: str


@dataclasses.dataclass
class Server:
    name: str
    domain: str                 # functional domain, e.g. "websearch"
    description: str            # d_m
    tools: list                 # list[Tool], d_{m,j}


@dataclasses.dataclass
class Query:
    text: str                   # raw user query q (may be noisy/misleading)
    intent: str                 # ground-truth domain (all WEBSEARCH in bench)
    answer: str                 # gold answer for the judge
    hard: bool = False          # phrasing engineered to defeat preprocessing


# ---------------------------------------------------------------------------
# Paraphrase diversification (stands in for the paper's LLM polishing)
# ---------------------------------------------------------------------------

_SYNONYMS = {
    "search": ["search", "lookup", "querying", "retrieval", "discovery"],
    "web": ["web", "internet", "online", "www"],
    "realtime": ["real-time", "live", "up-to-date", "fresh", "current"],
    "information": ["information", "facts", "content", "knowledge", "results"],
    "fast": ["fast", "quick", "responsive", "low-latency", "snappy"],
    "find": ["find", "fetch", "locate", "discover", "retrieve"],
}


def _paraphrase(template: str, rng: np.random.Generator) -> str:
    out = template
    for key, alts in _SYNONYMS.items():
        token = "{" + key + "}"
        while token in out:
            out = out.replace(token, alts[rng.integers(len(alts))], 1)
    return out


# ---------------------------------------------------------------------------
# Server pool (paper Sec. V-A: 5 websearch + 10 distractors)
# ---------------------------------------------------------------------------

_WEBSEARCH_TEMPLATES = [
    "Exa {web} {search} server: {find} {realtime} {information} from the {web} with neural {search}.",
    "{fast} {web} {search} engine to {find} news, articles and {realtime} {information} on the {web}.",
    "A general purpose {web} {search} service that can {find} {realtime} {information}, answer questions and browse the {web}.",
    "DuckDuckGo style {web} {search} MCP server for {realtime} {web} {information} {search}.",
    "Brave {search} server exposing {web} {search} and news {search} for {realtime} {information}.",
]

_WEBSEARCH_TOOL_TEMPLATES = [
    ("web_search", "{search} the {web} for a query and return ranked {information} snippets with urls"),
    ("news_search", "{search} recent news articles on the {web} for a query"),
]

_DISTRACTORS = [
    ("code-assistant", "coding",
     "AI coding assistant server for code modification, refactoring and bug fixing in repositories.",
     [Tool("edit_code", "apply a code modification or refactor to a source file"),
      Tool("review_code", "review a pull request diff and suggest code fixes")]),
    ("amazon-shop", "product",
     "Amazon product search server: browse the product catalog, compare price and place orders.",
     [Tool("product_search", "search the amazon catalog for a product and return price and rating"),
      Tool("order_status", "look up the shipping status of an order")]),
    ("postgres-db", "database",
     "PostgreSQL database server exposing SQL query execution, schema inspection and table statistics.",
     [Tool("run_sql", "execute a read-only sql query against the connected database"),
      Tool("describe_table", "return the schema of a database table")]),
    ("weather-station", "weather",
     "Weather data server providing current conditions and hourly forecasts for any city.",
     [Tool("get_weather", "get current weather conditions for a location"),
      Tool("get_forecast", "get the hourly weather forecast for a location")]),
    ("finance-desk", "finance",
     "Financial market data server for stock quotes, company fundamentals and portfolio analytics.",
     [Tool("stock_quote", "get the latest stock quote for a ticker symbol"),
      Tool("company_financials", "fetch fundamental financial statements of a company")]),
    ("travel-agent", "travel",
     "Travel booking server for flight search, hotel availability and itinerary planning.",
     [Tool("flight_search", "search flights between two airports on a date"),
      Tool("hotel_search", "search hotel availability in a city")]),
    ("linkedin-pro", "business",
     "Professional network server to search company profiles, founders and people on LinkedIn.",
     [Tool("company_lookup", "look up a company profile, its founders and employees"),
      Tool("people_search", "search professional profiles of people by name and role")]),
    ("file-vault", "filesystem",
     "Filesystem server granting secure read and write access to local files and directories.",
     [Tool("read_file", "read the contents of a file from the filesystem"),
      Tool("write_file", "write content to a file on the filesystem")]),
    ("mail-room", "email",
     "Email server for drafting, sending and searching email messages in a mailbox.",
     [Tool("send_email", "compose and send an email message"),
      Tool("search_mail", "search the mailbox for messages matching a query")]),
    ("calendar-hub", "calendar",
     "Calendar server to create events, check availability and schedule meetings.",
     [Tool("create_event", "create a calendar event with attendees"),
      Tool("find_slot", "find a free meeting slot for a set of attendees")]),
]


def build_server_pool(seed: int = 0) -> list:
    """The paper's 15-server experimental pool."""
    rng = np.random.default_rng(seed)
    servers: list = []
    for i, tmpl in enumerate(_WEBSEARCH_TEMPLATES):
        # Tool descriptions are LLM-diversified per server (same backend) —
        # paper Sec. V-A: descriptions "diversified by polishing and
        # rephrasing with an LLM ... while preserving identical underlying
        # functionalities".
        tools = [
            Tool(name, _paraphrase(tmpl_t, rng))
            for name, tmpl_t in _WEBSEARCH_TOOL_TEMPLATES
        ]
        servers.append(
            Server(
                name=f"websearch-{i}",
                domain=WEBSEARCH,
                description=_paraphrase(tmpl, rng),
                tools=tools,
            )
        )
    for name, domain, desc, tools in _DISTRACTORS:
        servers.append(Server(name=name, domain=domain, description=desc, tools=tools))
    return servers


def mock_cluster(
    templates: Sequence[Server],
    n_per_template: int,
    seed: int = 0,
) -> list:
    """Paper: "starting from a single real server such as Exa ... instantiate
    a cluster of 20 functionally similar virtual servers"."""
    rng = np.random.default_rng(seed)
    out: list = []
    for t in templates:
        for j in range(n_per_template):
            suffix = f" Virtual replica {j} deployed in zone {rng.integers(1, 9)}."
            out.append(
                Server(
                    name=f"{t.name}-r{j}",
                    domain=t.domain,
                    description=t.description + suffix,
                    tools=list(t.tools),
                )
            )
    return out


# ---------------------------------------------------------------------------
# Query dataset (MCPBench-style web-search tasks, Sec. V-A)
# ---------------------------------------------------------------------------
# All queries are web-search tasks (SSR counts selection of a websearch
# server).  Raw phrasings deliberately contain distractor-domain keywords —
# the paper's own example: "Who founded the first luxury goods company?"
# superficially matches a LinkedIn company tool.  A fraction is marked `hard`:
# phrasing so dominated by a distractor domain that even tool prediction
# mispredicts (keeps PRAG/SONAR SSR ~90-95%, matching Fig. 7/Table II).

_EASY = [
    ("Who founded the first luxury goods company?", "louis vuitton"),
    ("What is the tallest mountain in the solar system?", "olympus mons"),
    ("Which country hosted the 2016 summer olympics?", "brazil"),
    ("What year did the berlin wall fall?", "1989"),
    ("Who wrote the novel one hundred years of solitude?", "gabriel garcia marquez"),
    ("What is the capital city of australia?", "canberra"),
    ("Which element has the atomic number 79?", "gold"),
    ("Who painted the starry night?", "vincent van gogh"),
    ("What is the longest river in africa?", "nile"),
    ("Which planet has the most moons?", "saturn"),
    ("Who was the first woman to win a nobel prize?", "marie curie"),
    ("What is the national currency of japan?", "yen"),
    ("Which company acquired github in 2018?", "microsoft"),
    ("What is the population of iceland?", "380000"),
    ("Who discovered penicillin?", "alexander fleming"),
    ("What is the speed of light in vacuum?", "299792458"),
    ("Which language has the most native speakers?", "mandarin"),
    ("Who is the author of the art of war?", "sun tzu"),
    ("What is the deepest point of the ocean?", "mariana trench"),
    ("Which city is known as the big apple?", "new york"),
    ("What is the latest stable version of the linux kernel?", "6.x"),
    ("Who won the most recent formula one championship?", "verstappen"),
    ("What is the current price of bitcoin in usd?", "varies"),
    ("Which team won the last fifa world cup?", "argentina"),
    ("What was the weather like during the 1969 moon landing?", "n/a"),
    ("Who founded the company that makes the iphone?", "steve jobs"),
    ("What database technology does wikipedia run on?", "mariadb"),
    ("Which airline operates the longest direct flight?", "singapore airlines"),
    ("What is the newest national park in the united states?", "new river gorge"),
    ("Who composed the four seasons?", "vivaldi"),
    ("What is the busiest airport in the world by passengers?", "atlanta"),
    ("Which stock index tracks 500 large us companies?", "sp500"),
    ("What is the oldest university in europe?", "bologna"),
    ("Who invented the world wide web?", "tim berners-lee"),
    ("What is the smallest country in the world?", "vatican"),
    ("Which programming language was created by guido van rossum?", "python"),
    ("What is the tallest building in the world today?", "burj khalifa"),
    ("Who holds the record for most olympic gold medals?", "michael phelps"),
    ("What is the average distance from the earth to the moon?", "384400"),
    ("Which country produces the most coffee?", "brazil"),
    # info-seeking phrasings whose raw wording already matches websearch
    # descriptions (raw BM25 can succeed on these — keeps RAG SSR ~20%)
    ("Search the web for the latest mars rover discovery.", "perseverance"),
    ("Find online the current chess world champion.", "gukesh"),
    ("Look up on the internet who won the nobel peace prize last year.", "varies"),
    ("Search for real-time news about the next olympic games host.", "brisbane"),
    ("Find fresh information online about the newest iphone model.", "varies"),
    ("Search the internet for the release year of the first website.", "1991"),
    ("Web search: the fastest animal on earth.", "peregrine falcon"),
    ("Search online news for the tallest bridge in the world.", "millau"),
]

_HARD = [
    # phrasing dominated by distractor-domain vocabulary
    ("Refactor my understanding: which code of law is the oldest written one?", "code of ur-nammu"),
    ("Order and price history aside, which product did amazon sell first?", "book"),
    ("Email etiquette question: who sent the first email ever?", "ray tomlinson"),
    ("Schedule a fact for me: when is the next total solar eclipse?", "2026"),
    ("SQL of nature: which table element reacts most violently with water?", "cesium"),
]


def build_query_dataset(n: int = 120, seed: int = 0) -> list:
    """Deterministically cycle the templates up to n queries (~11% hard)."""
    rng = np.random.default_rng(seed)
    pool = [Query(t, WEBSEARCH, a, hard=False) for t, a in _EASY]
    pool += [Query(t, WEBSEARCH, a, hard=True) for t, a in _HARD]
    idx = rng.permutation(len(pool))
    out = [pool[idx[i % len(pool)]] for i in range(n)]
    return out
